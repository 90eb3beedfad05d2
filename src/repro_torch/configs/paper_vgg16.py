"""The paper's own DNN (Fig. 3): VGG16-style CNN for CIFAR-10, split after
block 1 (activation 16,384 dims = 65.5 kB f32).  [arXiv:2112.09407 §IV-A]
A copy of ``repro/configs/paper_vgg16.py``; like it, not in the LM
registry."""

from repro_torch.models.cnn import CNNConfig

CONFIG = CNNConfig(
    blocks=((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)),
    fc=(256, 128),
    num_classes=10,
    image_size=32,
    in_channels=3,
    split_block=1,
    width_scale=1.0,
)

# Reduced variant for CPU-budget runs: two convs a block, four blocks.
REDUCED = CNNConfig(
    blocks=((2, 32), (2, 64), (2, 128), (2, 128)),
    fc=(128, 64),
    num_classes=10,
    image_size=32,
    in_channels=3,
    split_block=1,
    width_scale=1.0,
)
