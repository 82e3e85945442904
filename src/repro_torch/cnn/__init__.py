"""repro_torch.cnn: the paper's CNN experiments (narrow ResNet-18, small
MobileNet) under UNIQ."""
