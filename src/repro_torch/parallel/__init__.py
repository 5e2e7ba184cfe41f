"""Sharding of the port (mirror of ``repro/parallel``): the placement
rules of parameters, optimizer state, batches and caches
(``sharding``) and the activation constraints (``act_sharding``), on
``torch.distributed`` DTensors, and the block-FP compressed cross-pod
gradient exchange (``blockfp``)."""
