"""Sharding rules over a ``torch.distributed`` DeviceMesh (counterpart of
``repro/distributed``)."""
