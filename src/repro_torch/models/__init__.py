"""The model stack: configs, layers, attention, RWKV-6, the forward, the
decode step, and the training and serving steps (port of
``src/repro/models``)."""
