"""User-facing walkthroughs of the sharded training steps (the
counterparts of the JAX package's ``examples/``)."""
