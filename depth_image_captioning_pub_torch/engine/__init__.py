"""Caption generation, scored evaluation and training on top of the
captioner."""
