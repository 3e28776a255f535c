"""Shape buckets, program keys and capability-trimmed programs
(PyTorch port of shadow_tpu/compile/, its host half).

- `buckets`: quantize every shape-bearing capacity knob to its
  power-of-two bucket and derive the canonical program key that
  identifies one program across runs and processes.
- `specialize`: derive a built scenario's capability vector and trim
  the dead loss draws and timer handlers from the programs its runners
  build, with a device guard latch that turns a violated assumption
  into a fatal health fault.

The reference's persistent program store and warm serving
(`store`, `serve`) are ROADMAP.md Queue 1 item 11b.
"""

from shadow_tpu_torch.compile import buckets, specialize  # noqa: F401
from shadow_tpu_torch.compile.buckets import (  # noqa: F401
    BUCKET_KNOBS,
    BucketPlan,
    bucket_config,
    code_version,
    is_program_key,
    kind_census,
    program_key,
    quantize_caps,
    quantize_pow2,
    shape_vector,
    shape_vector_for_sim,
)
