"""Gating and the MoE sublayer (counterpart of ``repro/core``)."""
