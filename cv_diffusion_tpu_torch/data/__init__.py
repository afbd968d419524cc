"""Training data of the port, in numpy: synthetic low-light pairs and the
batch loader the trainer takes."""
