"""Step factories of the LM substrate (counterpart of `repro.train`); this
slice holds the serving factories of `step.py`."""
