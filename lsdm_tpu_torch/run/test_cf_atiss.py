"""Evaluate the cf_atiss baseline (reference ``run/test_cf_atiss.py``): the
port's ``test_cf_atiss`` entry point, with the JAX CLI's flags
(``run/_baseline_common.py``).

    python -m lsdm_tpu_torch.run.test_cf_atiss D [--load_model M.pt] [--device cuda]
"""

from typing import Optional, Sequence

from lsdm_tpu_torch.run._baseline_common import eval_baseline, make_arg_parser


def main(argv: Optional[Sequence[str]] = None):
    args = make_arg_parser(train=False).parse_args(argv)
    return eval_baseline(args, "cf_atiss")


if __name__ == "__main__":
    main()
