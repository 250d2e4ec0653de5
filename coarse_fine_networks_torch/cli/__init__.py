"""The port's command lines, flag for flag the JAX package's
(``coarse_fine_networks_tpu/cli``): ``pretrain_kinetics``, ``train_fine``,
``extract_fineFEAT``, ``train_coarse_fineFEAT``, ``serve``,
``convert_checkpoint`` and ``pack_dataset``, each run as ``python -m
coarse_fine_networks_torch.cli.<name>``, plus ``--device`` (``cuda``
unless given) where a model runs."""
