"""The port's command line on the CPU, for launches the CLI cannot ask
for the CPU in (keypointfusion_torch.train's entry point runs on the
card):

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m tests.torch_port_cli_cpu --phase test ...

runs keypointfusion_torch.train.main(argv, device='cpu') in each rank.
Imports the port only (tests/test_torch_port_parallel.py)."""

import sys

from keypointfusion_torch import train

if __name__ == '__main__':
    train.main(sys.argv[1:], device='cpu')
