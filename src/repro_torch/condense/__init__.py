"""Token condensation (paper §V; counterpart of ``repro/condense``): the
similarity backends and the condensation plan, on one device."""
