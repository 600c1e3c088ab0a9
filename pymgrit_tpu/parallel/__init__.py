"""Distribution over device meshes (time x space)."""
