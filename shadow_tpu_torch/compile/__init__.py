"""Shape buckets, program keys and capability-trimmed programs
(PyTorch port of shadow_tpu/compile/, its host half).

- `buckets`: quantize every shape-bearing capacity knob to its
  power-of-two bucket and derive the canonical program key that
  identifies one program across runs and processes.
- `specialize`: derive a built scenario's capability vector and trim
  the dead loss draws and timer handlers from the programs its runners
  build, with a device guard latch that turns a violated assumption
  into a fatal health fault.

- `store`: the persistent on-disk map from program key to the
  program's resolved plan and the native libraries it loads, with
  sidecar manifests, atomic writes, corruption/version fallback and
  LRU gc.
- `serve`: the lazy warm wrapper dispatch paths use instead of calling
  their dispatch callables directly, plus the `prewarm` entry point
  that populates the store ahead of a run.
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
from shadow_tpu_torch.compile.serve import (  # noqa: F401
    maybe_warm,
    prewarm,
    warm_enabled,
)
from shadow_tpu_torch.compile.store import (  # noqa: F401
    ProgramStore,
    default_store,
)
