"""Data sets of the examples (counterpart of ``pyro_tpu/contrib/examples``;
so far ``bart``)."""
