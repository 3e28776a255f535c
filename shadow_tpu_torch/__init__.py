"""shadow_tpu_torch — the PyTorch/CUDA port of shadow_tpu.

The same conservative windowed-PDES engine, UDP and TCP netstack (with
the UDP and TCP bulk window passes), and PHOLD, Tor-relay (disjoint
and shared-relay) and Bitcoin-gossip (UDP and TCP) applications as
``shadow_tpu``, written with PyTorch tensors so that it runs on an
NVIDIA GPU (Hopper, ``sm_90a``). Like the reference's, the package
exports no names of its own beyond ``__version__``: import the modules.
Module names mirror ``shadow_tpu/`` one for one, so each counterpart
is easy to find; the JAX package stays the reference and this port is
held against it bit for bit (same config and seed -> the same
``EngineStats`` and the same value in every state leaf). Its
robustness layer, ``faults/`` (fault plans, crash and restart, health
latches, the supervised window loop with capacity escalation), is the
reference's too.

Rules the package keeps:

- It imports ``torch`` and ``numpy`` only — never ``jax``, ``flax`` or
  ``shadow_tpu`` (host-only helpers are copied, not imported).
- Every entry point takes ``device``; unset, it is ``"cuda"``, and a
  missing GPU raises instead of falling back to the CPU.
- The simulator's randomness is the threefry counter stream of
  ``core/rng.py``, carried in state (no ``torch.Generator``).
- Settings the port does not implement yet raise ``NotImplementedError``
  at ``net.build.build``.

The one TPU kernel of the reference on this path, ``mailbox_gather``,
is a hand-written CUDA kernel (``csrc/mailbox_gather.cu``, bound in
``core/insert_kernels.py``).
"""

__version__ = "0.1.0"
