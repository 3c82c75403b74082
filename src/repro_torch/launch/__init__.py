"""Launchers and launch tooling of the port: ``launch.train`` (the trainer
over a ``(ranks, 1)`` mesh), ``mesh`` (the production ``DeviceMesh`` and
the dry run's fake process group), ``shardings`` (the sharding rules as
DTensor placements), ``roofline`` (H100 constants, the roofline terms, the
kernels' launch model), ``op_cost`` (the op-level cost counter),
``dryrun`` (every cell's step traced on fake tensors) and ``report`` (its
table)."""
