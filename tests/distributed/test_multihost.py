"""Multi-host tier (SURVEY.md §4): 2 CPU processes over localhost TCP.

Each process exposes 4 virtual devices; the global ("frame"=2, "ty"=4)
mesh runs the tiled stereo pipeline with the frame axis spanning processes
(the cross-host axis) and halo wavefronts inside each process.
Result must be bit-identical to the single-process reference.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

WORKER = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.pop("JAX_PLATFORMS", None)
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from fsgm_tpu.params import SGMParams, DistParams
    from fsgm_tpu.io.synthetic import random_dot_stereo
    from fsgm_tpu.parallel.tiled import stereo_sgm_sharded
    from fsgm_tpu.parallel.multihost import global_mesh

    assert jax.process_count() == nproc
    assert jax.device_count() == 4 * nproc
    mesh = global_mesh()

    p = SGMParams(max_disp=16, p1=7, p2=60)
    dist = DistParams(tiles_y=4, frame_shards=nproc, tile_mode="exact")
    pairs = [random_dot_stereo(32, 48, 16, seed=s) for s in range(nproc)]
    il = jnp.asarray(np.stack([q[0] for q in pairs]))
    ir = jnp.asarray(np.stack([q[1] for q in pairs]))
    out = stereo_sgm_sharded(il, ir, p, dist, mesh)
    # each process writes the region its devices own
    full = np.full(out.shape, np.nan, np.float32)
    for sh in out.addressable_shards:
        full[sh.index] = np.asarray(sh.data)
    np.save(sys.argv[4] + f".{pid}.npy", full)
    jax.distributed.shutdown()
""")


@pytest.mark.slow
def test_two_process_localhost(tmp_path):
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)
    out_base = str(tmp_path / "out")
    port = "29517"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(worker_py), str(pid), "2", port, out_base],
        env=env, cwd=os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = [p.communicate(timeout=420)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}"

    # combine per-process shards; frame f lives on process f
    import jax.numpy as jnp
    from fsgm_tpu.params import SGMParams
    from fsgm_tpu.models.stereo import stereo_sgm
    from fsgm_tpu.io.synthetic import random_dot_stereo
    p = SGMParams(max_disp=16, p1=7, p2=60)
    for s in range(2):
        got = np.load(f"{out_base}.{s}.npy")[s]
        assert not np.isnan(got).any(), "process did not own its frame"
        il, ir, _ = random_dot_stereo(32, 48, 16, seed=s)
        ref = np.asarray(stereo_sgm(jnp.asarray(il), jnp.asarray(ir), p))
        np.testing.assert_array_equal(got, ref)
