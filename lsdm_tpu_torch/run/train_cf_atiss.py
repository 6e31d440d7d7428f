"""Train the cf_atiss baseline (reference ``run/train_cf_atiss.py``): the
port's ``train_cf_atiss`` entry point, with the JAX CLI's flags
(``run/_baseline_common.py``).

    python -m lsdm_tpu_torch.run.train_cf_atiss --train_data_dir D [--epochs 100] [--device cuda]
"""

from typing import Optional, Sequence

from lsdm_tpu_torch.run._baseline_common import train_baseline, make_arg_parser


def main(argv: Optional[Sequence[str]] = None):
    args = make_arg_parser(train=True).parse_args(argv)
    return train_baseline(args, "cf_atiss")


if __name__ == "__main__":
    main()
