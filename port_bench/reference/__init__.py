"""Plain references the benchmark judges the program's outputs by. Nothing
here imports the program, `jax` or the JAX package."""
