"""Multi-rank execution of the port (counterpart of shadow_tpu/parallel):
hosts sharded over the ranks of a torch.distributed process group,
one process per shard (parallel/shard.py). The reference's
parallel/elastic.py (device-loss classification, the integrity
sentinel, shrink planning) is not ported yet: ROADMAP.md Queue 1
item 9b."""

from shadow_tpu_torch.parallel.shard import (  # noqa: F401
    AXIS,
    Mesh,
    free_port_init,
    make_sharded_chunk,
    make_sharded_runner,
    make_sharded_window,
    route_outbox_sharded,
    run_sharded,
    shard_sim,
    sharded_engine_run,
    sim_specs,
    spawn,
    unshard_sim,
)
