"""Training machinery of the port: schedules, optimizers, checkpoints, the
trainer loop and its logger."""
