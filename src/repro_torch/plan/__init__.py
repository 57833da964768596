"""The MoE exchange plan and its executor (counterpart of ``repro/plan``)."""
