"""The benchmark of the PyTorch and CUDA port (keypointfusion_torch)."""
