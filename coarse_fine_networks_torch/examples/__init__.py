"""Runnable demos of the port (``python -m
coarse_fine_networks_torch.examples.<name>``): the three-stage pipeline on
generated data (:mod:`.demo_synthetic`) and the serving stack over HTTP
(:mod:`.demo_serving`), each the counterpart of the repository's
``examples/`` script of the same name."""
