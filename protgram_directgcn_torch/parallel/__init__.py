"""Sharded training, one process per device under ``torch.distributed``.

Port of protgram_directgcn_tpu/parallel/ for the ``halo``, ``hypercube`` and
``gspmd`` modes over a 2-D rank grid of node shards by feature shards:
``distributed`` starts the process group and holds the collectives (with
process subgroups), ``halo``, ``hyper_shard`` and ``gspmd`` the sharded
operators, ``mesh`` the rank grid and the sharding of operators, parameters
and inputs over it.
"""
