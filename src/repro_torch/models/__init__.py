"""Blocks, the transformer stack and the public model API
(counterpart of ``repro/models``)."""
