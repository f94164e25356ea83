"""fsgm_tpu — SGM stereo and fSGM optical flow in JAX.

Public API:

    from fsgm_tpu import stereo_sgm, flow_fsgm, SGMParams, FlowParams

    disp = stereo_sgm(img_l, img_r, SGMParams(max_disp=128))
    flow = flow_fsgm(img1, img2, FlowParams(search_radius=4, levels=4))

Distribution (multi-device / multi-host):

    from fsgm_tpu.parallel import (stereo_sgm_sharded, flow_fsgm_sharded,
                                   stereo_sgm_dsharded)

See README.md for the architecture and PERF.md for measurements.
"""

from fsgm_tpu.params import (SGMParams, FlowParams, DistParams, DIRS_8,
                             DIRS_16, INVALID, load_preset)

__version__ = "0.1.0"
__all__ = [
    "SGMParams", "FlowParams", "DistParams", "DIRS_8", "DIRS_16",
    "INVALID", "load_preset", "stereo_sgm", "stereo_sgm_batch",
    "flow_fsgm", "flow_sequence",
]


def __getattr__(name):
    # lazy: importing the pipelines pulls in jax; keep bare-package import
    # cheap for tooling
    if name == "stereo_sgm":
        from fsgm_tpu.models.stereo import stereo_sgm
        return stereo_sgm
    if name == "stereo_sgm_batch":
        from fsgm_tpu.models.stereo import stereo_sgm_batch
        return stereo_sgm_batch
    if name == "flow_fsgm":
        from fsgm_tpu.models.flow import flow_fsgm
        return flow_fsgm
    if name == "flow_sequence":
        from fsgm_tpu.models.flow import flow_sequence
        return flow_sequence
    raise AttributeError(name)
