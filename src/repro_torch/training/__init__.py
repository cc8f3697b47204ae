"""Training of the port: weighted cross-entropy and the train step
(``loss``), AdamW with a cosine schedule and global-norm clipping
(``optimizer``), and the training driver (``train_loop``), ports of the
JAX package's ``training/`` modules."""
