"""Training of the port: per-stage optimizers (``optim``) and train and
eval steps (``stages``)."""
