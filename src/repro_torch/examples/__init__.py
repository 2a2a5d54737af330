"""Walkthroughs of the port, one module each (the reference's
``examples/`` on ``repro_torch``): ``python -m
repro_torch.examples.<name> [--device cpu]``; the card by default."""
