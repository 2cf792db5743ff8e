"""Device-side ops: featurizer, the kNN index and the ``fused_topk`` kernel."""
