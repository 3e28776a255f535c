"""The operator tools of tools/ as modules of the port: each is the twin
of one ``tools/<name>.py`` of the reference, with its flags, its
standard output (JSON lines, exit codes) and its public functions, and
runs as ``python -m shadow_tpu_torch.tools.<name>``.

- scale_run:               the scale harness (phold, relay, tor, gossip)
- chaos_soak:              the randomized kill/heal soak and its oracles
- compcache_ctl:           the program store's console (ls, stats, gc,
                           prewarm, prewarm --sweep)
- faultplan_lint:          the offline fault-plan validator
- trace_gen:               synthetic injection traces
- generate_example_config: example config and topology files
- dualmode_diff:           vproc workloads on the simulator and the host

Like every module of the port they import torch, never jax, and
nothing of shadow_tpu. The entry points that run a simulation run on
the card unless the caller asks for the CPU (scale_run ``--cpu``,
chaos_soak ``--platform cpu``, ``device="cpu"`` in code); without CUDA
they fail and name the device.
"""
