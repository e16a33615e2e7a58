"""The learned residual model (residual.py) and its serving engine
(serve.py), on PyTorch."""
