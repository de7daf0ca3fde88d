"""Training of the LM substrate (counterpart of `repro.train`): AdamW with
float32 or int8 moments (`optim.py`), the train and serve step factories
(`step.py`) and the resumable loop with its telemetry (`loop.py`)."""
