"""The multi-device layer (counterpart of the JAX package's ``parallel/``).

One process per rank over ``torch.distributed`` (SPMD): every rank runs
the same host program on the same global inputs, slices out its own
shard, and the collectives of a mesh axis (``distributed.Axis``) stand
where ``shard_map``'s in/out specs and ``psum`` / ``all_gather`` /
``ppermute`` stand in JAX.

- ``distributed``: process-group start-up, the rank launcher, the axis
  handle and its collective counters;
- ``sharding``: meshes of ranks, the Megatron specs and the shard slicers;
- ``tp``: the tensor/data-parallel forward (``make_tp_forward``);
- ``sp``: the sequence-parallel ring prefill (``make_sp_prefill``);
- ``pp``: the pipeline-parallel forward (``make_pp_forward``).
"""
