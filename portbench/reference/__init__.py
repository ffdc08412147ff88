"""The plain reference of the check: no jax, nothing of the program."""
