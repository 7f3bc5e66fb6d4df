"""Entry points of the port: the trainer (``launch/train.py``)."""
