"""``python -m onepose_plus_plus_tpu_torch.train +experiment=train.yaml [overrides]``."""
from .cli import main

if __name__ == "__main__":
    main()
