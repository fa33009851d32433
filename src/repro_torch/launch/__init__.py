"""Process groups for the distributed GP step (the JAX package's meshes)."""
