"""Distribution over ranks: one process per rank, each holding only its
shard (``torch.distributed``).  :mod:`~repro_torch.sharding.plan` says how a
model is placed, :mod:`~repro_torch.sharding.partitioning` holds the rule
table, :mod:`~repro_torch.sharding.context` the active mesh and its groups,
:mod:`~repro_torch.sharding.pipeline` the GPipe schedule."""
