"""The model plane: the in-tree Llama, its cached attention and its serving."""
