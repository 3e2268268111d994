"""Host-side data layer: special tokens and detokenizer, vocabulary
loading, evaluation batches."""
