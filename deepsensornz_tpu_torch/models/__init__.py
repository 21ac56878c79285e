"""U-Net, likelihood heads and the ConvNP model."""
