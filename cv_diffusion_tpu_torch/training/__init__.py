"""Training of the port: train state, train and eval steps, EMA,
checkpoints and the host-side trainer."""
