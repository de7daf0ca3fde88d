"""Synthetic datasets of the port (counterpart of `repro.data`): the
BlinkDB tables (`synth.py`) and the LM token stream (`tokens.py`)."""
