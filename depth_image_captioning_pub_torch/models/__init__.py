"""PyTorch modules: ResNet grid encoder, attention decoder, captioner."""
