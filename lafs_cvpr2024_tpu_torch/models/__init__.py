"""Models: Part-fViT, its transformer layers and the MobileNetV3 stem."""
