"""Prefill and single-token decode with a KV cache (counterpart of
``repro/serve``)."""
