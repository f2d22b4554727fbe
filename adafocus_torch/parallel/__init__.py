"""Data parallelism: one process a replica (``parallel.mesh``) and the
data-parallel dry run (``python -m adafocus_torch.parallel.dryrun``)."""
