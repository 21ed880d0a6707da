"""Runnable twins of the reference's examples: ``python -m
repro_torch.examples.<name> [--cpu]`` (on the card unless ``--cpu``)."""
