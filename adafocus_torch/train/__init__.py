"""Training of the port: per-stage optimizers (``optim``) and train and
eval steps (``stages``; the sth-sth family's ``stages_sthsth``)."""
