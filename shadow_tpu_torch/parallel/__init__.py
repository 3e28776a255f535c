"""Multi-rank execution of the port (counterpart of shadow_tpu/parallel):
hosts sharded over the ranks of a torch.distributed process group,
one process per shard (parallel/shard.py), and elastic degraded-mesh
recovery — device-loss classification, the integrity sentinel and
shrink planning (parallel/elastic.py).

The names below are loaded on first use, so the state containers
(convert.py imports elastic.SentinelState) never import the runners."""

_SHARD_NAMES = frozenset({
    "AXIS", "Mesh", "free_port_init", "make_sharded_chunk",
    "make_sharded_runner", "make_sharded_window", "route_outbox_sharded",
    "run_sharded", "shard_sim", "sharded_engine_run", "sim_specs",
    "spawn", "unshard_sim",
})


def __getattr__(name):
    if name in _SHARD_NAMES:
        from shadow_tpu_torch.parallel import shard

        return getattr(shard, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(_SHARD_NAMES)
