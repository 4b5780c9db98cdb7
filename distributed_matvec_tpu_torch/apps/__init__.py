"""Command-line entry points of the port, run as modules
(``python -m distributed_matvec_tpu_torch.apps.<name>``).  Importing them
has no side effects."""
