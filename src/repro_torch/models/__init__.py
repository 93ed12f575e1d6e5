"""The model stack: configs, layers, attention, RWKV-6, the forward, the
decode step and the serving steps (port of ``src/repro/models``)."""
