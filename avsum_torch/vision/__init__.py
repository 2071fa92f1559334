"""Vision: ResNet50, InceptionV3, the dual backbone, shot pooling."""
