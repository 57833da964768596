"""Hand-written Hopper kernels, their plain versions and the dispatch
layer (counterpart of ``repro/kernels``)."""
