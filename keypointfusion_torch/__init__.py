"""PyTorch/CUDA port of KeypointFusion for NVIDIA Hopper (H100).

A package beside the JAX reference `keypointfusion_tpu`, with the same
layout and names; it imports neither JAX nor the JAX package. The serving
path of KPFusion-resnet-18 is ported, in float32 and bfloat16: on-device
preprocessing (data/device_preprocess.py), the model (models/kpfusion.py),
the streaming engine (serving.py) and the CUDA kernels that path runs
(kernels/, csrc/); its train step in float32, 'mixed' and bfloat16
(training/train_step.py); and the trainer (training/trainer.py: epochs,
test metrics, checkpoints, resume, warm starts) with its batch loader
(data/pipeline.py).
"""
