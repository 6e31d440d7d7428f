"""Where the time of the ATISS / MIME baselines goes, on a CUDA device.

    python -m lsdm_tpu_torch.profile_atiss [--kinds atiss mime] [--batch 4]
        [--repeats 10]

At the reference widths (``run/_baseline_common.py:build_model``: 20 =
13 proxd categories + 7 classes, the ResNet18 extractor with frozen
BatchNorm and 64 features, 4 encoder layers of 512 (MIME 528), 8 heads, ff
1024, scalar heads) with seeded weights and one seeded batch of
``--batch`` scenes of 9 box slots (``atiss_inputs``): each kind's forward
(CUDA events over ``--repeats`` calls after a warm-up), its train step
(``run/_baseline_common.py:baseline_step``, AdamW; host clock around each
synchronised step) with its peak memory, the generation of one scene
(``generate_boxes``, 12 slots, ms a box), then one traced forward and one
traced step with ``torch.profiler``: each kernel's device time, the
launches and the busy share (summed kernel time over the traced wall).
TF32 off.  The last line is one JSON object with all of it.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import torch

ATISS_KINDS = ("atiss", "quirk", "pe", "mime")
_SEEDED = {}  # (kind, seed): the seeded model, copied for each caller


def atiss_inputs(kind: str, batch: int = 4, seed: int = 0, slots: int = 9):
    """A seeded model of ``kind`` ("atiss", its batch-axis "quirk", the "pe"
    variant, "mime"; ResNet18 features) at the reference widths, on the
    CPU, and one batch as ``boxes_from_batch`` makes it: ``batch`` scenes
    of ``slots`` boxes (one-hot classes of the 13 proxd categories,
    translations, sizes, zero angles, 2 to ``slots`` valid slots a scene,
    slot 0 always), a binary room mask, the trainer's ``*_tr`` ones; and
    the train step's targets.  Returns (model, boxes, (gt_translation,
    gt_size, target_cat))."""
    from argparse import Namespace

    from lsdm_tpu_torch.run._baseline_common import build_model
    from lsdm_tpu_torch.weights import init_weights

    if (kind, seed) not in _SEEDED:
        args = Namespace(feature_extractor="resnet18", no_freeze_bn=False,
                         torch_seq_axis_quirk=kind == "quirk", pe=kind == "pe")
        model, _ = build_model("mime" if kind == "mime" else "atiss", 13, args)
        _SEEDED[(kind, seed)] = init_weights(model, seed).eval()
    model = copy.deepcopy(_SEEDED[(kind, seed)])
    C = model.n_classes
    g = torch.Generator().manual_seed(seed)
    B, L = batch, slots
    cats = torch.randint(0, 13, (B, L), generator=g)
    valid = (torch.arange(L)[None] < torch.randint(2, L + 1, (B, 1), generator=g)).float()
    boxes = {
        "class_labels": torch.nn.functional.one_hot(cats, C).float(),
        "translations": torch.randn(B, L, 3, generator=g),
        "sizes": torch.rand(B, L, 3, generator=g) * 2,
        "angles": torch.zeros(B, L, 1),
        "valid_mask": valid,
        "room_layout": (torch.rand(B, 1, 64, 64, generator=g) > 0.3).float(),
        "class_labels_tr": torch.ones(B, 1, C),
        "translations_tr": torch.ones(B, 1, 3),
        "sizes_tr": torch.ones(B, 1, 3),
        "angles_tr": torch.ones(B, 1, 1),
    }
    if kind == "mime":
        boxes["contact_labels"] = (torch.arange(L)[None, :, None] == 0).float().expand(
            B, L, 1).contiguous()
    targets = (torch.randn(B, 3, generator=g), torch.rand(B, 3, generator=g) * 2,
               torch.nn.functional.one_hot(torch.randint(0, 13, (B,), generator=g),
                                           13).float())
    return model, boxes, targets


def time_forward(model, boxes, repeats: int) -> float:
    """Mean ms of ``repeats`` no-grad forwards of ``model`` on ``boxes`` on
    the card after a warm-up, by CUDA events."""
    def forward():
        with torch.no_grad():
            model(boxes)

    forward()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        forward()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def time_steps(state, boxes, targets, repeats: int):
    """``repeats`` train steps (``baseline_step``) of ``state`` after a
    warm-up step, each on the host clock between synchronisations: (the
    steps' ms, the peak GiB allocated after the warm-up, the last loss)."""
    from lsdm_tpu_torch.run._baseline_common import baseline_step

    steps = []
    for i in range(repeats + 1):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = baseline_step(state, boxes, *targets)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    return steps[1:], torch.cuda.max_memory_allocated() / 2 ** 30, float(loss)


def time_generation(model, room, gen, max_boxes: int):
    """ms a box of one ``generate_boxes`` scene of ``max_boxes`` slots on
    the card after a warm-up scene, on the host clock: (ms a box, boxes)."""
    from lsdm_tpu_torch.models.atiss import generate_boxes

    generate_boxes(model, room, gen, max_boxes=max_boxes)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, count = generate_boxes(model, room, gen, max_boxes=max_boxes)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / count, count


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kinds", nargs="+", default=["atiss", "mime"],
                    choices=ATISS_KINDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_atiss: no CUDA device")
    from lsdm_tpu_torch.profile_contact import _trace
    from lsdm_tpu_torch.run._baseline_common import baseline_step
    from lsdm_tpu_torch.train.state import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"card": torch.cuda.get_device_name(0), "batch": args.batch}
    for kind in args.kinds:
        model, boxes, targets = atiss_inputs(kind, args.batch)
        model.to(dev)
        boxes = {k: v.to(dev) for k, v in boxes.items()}
        targets = [t.to(dev) for t in targets]
        rec = {"params": sum(p.numel() for p in model.parameters()),
               "forward_ms": time_forward(model, boxes, args.repeats)}
        state = create_train_state(model, lr=1e-3, weight_decay=0.01)
        rec["step_ms"], rec["peak_gib"], _ = time_steps(state, boxes, targets,
                                                        args.repeats)
        gen = torch.Generator(device=dev).manual_seed(0)
        rec["generate_ms_per_box"], count = time_generation(
            model, boxes["room_layout"][:1], gen, 12)
        rec["generated_boxes"] = count

        def forward():
            with torch.no_grad():
                model(boxes)

        rec["trace_forward"] = _trace(forward, f"{kind} forward B={args.batch}")
        rec["trace_step"] = _trace(lambda: baseline_step(state, boxes, *targets),
                                   f"{kind} train step B={args.batch}")
        print(f"{kind}: {rec['params']} parameters; forward {rec['forward_ms']:.3f} ms, "
              f"train step {[round(x, 3) for x in rec['step_ms']]} ms, peak "
              f"{rec['peak_gib']:.3f} GiB, generation {rec['generate_ms_per_box']:.3f} "
              f"ms a box ({count} boxes)")
        out[kind] = rec
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
