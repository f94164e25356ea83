"""Golden CPU reference model (NumPy + C++ mirror in golden/cpp/).

This package is the parity oracle for the JAX pipeline: the reference
checkout at /root/reference was empty at survey time (SURVEY.md §0), and
BASELINE.json config 1 designates a "CPU-runnable ref" — this is it.
Everything census -> S is integer arithmetic, so the device paths are tested for
EXACT equality against this model (SURVEY.md §4).
"""

from golden.sgm import (
    census_transform,
    cost_volume_stereo,
    aggregate_paths,
    aggregate_one_path,
    wta,
    wta_right_from_S,
    subpixel_refine,
    lr_check,
    median_filter_3x3,
    sgm_stereo,
)
from golden.flow import (
    cost_volume_flow,
    aggregate_paths_flow,
    fsgm_flow,
    downsample2x,
    upsample_flow_2x,
)
