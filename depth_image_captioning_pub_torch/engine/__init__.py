"""Caption generation on top of the captioner."""
