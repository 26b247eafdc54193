"""Node-sharded training, one process per device under ``torch.distributed``.

Port of protgram_directgcn_tpu/parallel/ for the ``halo`` and ``hypercube``
modes: ``distributed`` starts the process group and holds the collectives,
``halo`` and ``hyper_shard`` the sharded operators, ``mesh`` the rank layout
and the sharding of parameters and inputs.
"""
