"""Train the mime baseline (reference ``run/train_mime.py``): the
port's ``train_mime`` entry point, with the JAX CLI's flags
(``run/_baseline_common.py``).

    python -m lsdm_tpu_torch.run.train_mime --train_data_dir D [--epochs 100] [--device cuda]
"""

from typing import Optional, Sequence

from lsdm_tpu_torch.run._baseline_common import train_baseline, make_arg_parser


def main(argv: Optional[Sequence[str]] = None):
    args = make_arg_parser(train=True).parse_args(argv)
    return train_baseline(args, "mime")


if __name__ == "__main__":
    main()
