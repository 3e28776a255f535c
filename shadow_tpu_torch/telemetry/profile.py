"""torch.profiler captures for `--profile-dir` (cli.py) and
BENCH_PROFILE_DIR (bench.py): the port's twin of the reference's
`jax.profiler.start_trace(dir)` / `stop_trace()` pair.

A Capture records the host's operators and, when the run's device is a
card, the CUDA activity (kernels, copies, the runtime's launch calls)
over one span, and exports it into the directory as a Chrome trace
(`torch_trace.<pid>.json`, readable by chrome://tracing or
ui.perfetto.dev). The run manifest's `profile` block, {"dir": abspath,
"tool": "torch.profiler"}, says where the artifact landed.
"""

from __future__ import annotations

import os

TOOL = "torch.profiler"


class Capture:
    """One profiler span into `directory`, started at construction on
    `device` ("cuda" adds the CUDA activities). stop() ends the span
    and exports the trace (idempotent); `path` is the trace file after
    it, `block` the manifest's `profile` block."""

    def __init__(self, directory: str, device="cpu"):
        import torch
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(directory, exist_ok=True)
        self.dir = os.path.abspath(directory)
        self.path = None
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()

    @property
    def block(self) -> dict:
        return {"dir": self.dir, "tool": TOOL}

    def stop(self) -> str | None:
        if self._prof is None:
            return self.path
        prof, self._prof = self._prof, None
        prof.stop()
        path = os.path.join(self.dir, f"torch_trace.{os.getpid()}.json")
        prof.export_chrome_trace(path)
        self.path = path
        return path
