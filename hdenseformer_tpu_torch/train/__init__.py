"""Training of the port: optimizers and schedules (``state.py``), the train
and eval steps and the ``SemanticSeg`` trainer (``loop.py``), checkpoints
(``checkpoint.py``) and the metrics log (``logging.py``)."""
