"""Training of the port: optimizers and schedules (``state.py``), the train
and eval steps (``loop.py``)."""
