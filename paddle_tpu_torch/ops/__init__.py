"""Tensor ops of the port: each hand-written kernel sits beside its
plain PyTorch version (paged_decode.py) and is built by _build.py."""
