"""Training entry point: `train`'s command line (train/trainer.py)."""


def main(argv, prog: str = "hifimeth-tpu-torch train") -> int:
    from .trainer import main as trainer_main
    return trainer_main(argv, prog)
