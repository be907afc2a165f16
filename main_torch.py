#!/usr/bin/env python3
"""Entry point of the PyTorch/CUDA port (adam_dehaze_tpu_torch).

    python3 main_torch.py --mode {preprocess, train_classifier, train_dehazing,
                                  train_joint, train_all, train_detection,
                                  evaluate, demo, serve, export, bench} [--device cpu] ...

The options are those of main.py; see adam_dehaze_tpu_torch/cli.py.
"""
from adam_dehaze_tpu_torch.cli import main

if __name__ == "__main__":
    main()
