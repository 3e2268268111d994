"""Host-side data layer: special tokens, tokenizer and detokenizer,
vocabulary loading, train and evaluation batches, synthetic sets."""
