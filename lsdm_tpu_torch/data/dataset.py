"""Dataset loaders for the PRO-teXt / HUMANISE contracts.

A copy of ``lsdm_tpu/data/dataset.py`` (``Batch``, ``ProxDatasetTxt``,
``Humanise``, ``DataLoader``), which cannot be imported without jax (the
JAX package's ``data/__init__.py`` pulls it in).  What differs: ``.npy``
files are read with ``np.load`` (the JAX package's optional native reader
gives the same arrays), and the category tables come from the port's
config copy.  ``tests/test_torch_cli.py`` holds the items to the original's.

On-disk layout (reference ``posa/dataset.py:348-602``):

  <data_dir>/context/<seq>.txt      3 lines: prompt / given objects / target
  <data_dir>/reduced_vertices/<seq>.npy   (1024, 3) human cloud
  <objs_dir>/<scene>/<obj>.npy            (1024, 3) object cloud

``__getitem__`` returns (obj_mask (9,), obj_verts (9, 1024, 3) with slot 0
= human, obj_cats (9, max_cats) one-hot, target_verts (1024, 3),
target_cat (max_cats,), text_prompt, seq_name), with the reference's quirk
that the human slot's mask stays 0 (``posa/dataset.py:458-460``).
Batching pads the last batch by repeating its last item.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import queue as queue_mod
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from lsdm_tpu_torch.config import categories_for


@dataclasses.dataclass
class Batch:
    """A batch of float32 numpy arrays, the prompts and the sequence names."""

    mask: np.ndarray  # (B, max_objs)
    given_objs: np.ndarray  # (B, max_objs, N, 3)
    given_cats: np.ndarray  # (B, max_objs, C)
    target_verts: np.ndarray  # (B, N, 3)
    target_cat: np.ndarray  # (B, C)
    text: List[str]
    seq_names: List[str]


def _load_npy(path: str) -> np.ndarray:
    return np.load(path)


class ProxDatasetTxt:
    """PRO-teXt dataset (reference ``ProxDataset_txt``, ``posa/dataset.py:348``)."""

    datatype = "proxd"

    def __init__(
        self,
        data_dir: str,
        objs_data_dir: str = "data/protext/objs",
        max_objs: int = 8,
        pnt_size: int = 1024,
        max_cats: int = 13,
        fix_orientation: bool = False,
        jump_step: int = 8,
        max_frame: int = 220,
        **_,
    ):
        self.data_dir = data_dir
        self.objs_dir = objs_data_dir
        self.max_objs = max_objs
        self.pnt_size = pnt_size
        self.max_cats = max_cats
        self.cat_table = categories_for(self.datatype)

        self.context_dir = os.path.join(data_dir, "context")
        self.reduced_verts_dir = os.path.join(data_dir, "reduced_vertices")
        self.seq_names = sorted(
            f.split(".txt")[0] for f in os.listdir(self.context_dir)
        )
        self._setup_static_objs()

        self.reduced_verts: Dict[str, np.ndarray] = {}
        self.context: Dict[str, Tuple[str, List[str], str]] = {}
        for seq in self.seq_names:
            self.reduced_verts[seq] = _load_npy(
                os.path.join(self.reduced_verts_dir, seq + ".npy")
            ).astype(np.float32)
            with open(os.path.join(self.context_dir, seq + ".txt")) as f:
                lines = f.readlines()
            prompt = lines[0].strip("\n")
            given = lines[1].strip("\n").split(" ")
            target = lines[2].strip()
            self.context[seq] = (prompt, given, target)

    # scene-name resolution differs between datasets
    def _scene_of(self, seq_name: str) -> str:
        return seq_name.split("_")[0]  # reference :449

    def _cat_of(self, obj_name: str) -> int:
        # proxd: cabinet_1.npy style; name before first '.' then '_'
        return self.cat_table[obj_name.split(".")[0].split("_")[0]]

    def _setup_static_objs(self):
        self.objs: Dict[str, Dict[str, np.ndarray]] = {}
        self.cats: Dict[str, Dict[str, int]] = {}
        for scene in os.listdir(self.objs_dir):
            self.objs[scene] = {}
            self.cats[scene] = {}
            for obj_file in os.listdir(os.path.join(self.objs_dir, scene)):
                obj = obj_file[:-4]
                cat_name = obj.split(".")[0].split("_")[0]
                if cat_name not in self.cat_table:
                    continue
                self.objs[scene][obj] = _load_npy(
                    os.path.join(self.objs_dir, scene, obj_file)
                ).astype(np.float32)
                self.cats[scene][obj] = self.cat_table[cat_name]

    def __len__(self) -> int:
        return len(self.seq_names)

    def __getitem__(self, idx: int):
        seq = self.seq_names[idx]
        scene = self._scene_of(seq)
        all_objs = self.objs[scene]
        prompt, given, target = self.context[seq]
        human = self.reduced_verts[seq]

        S = self.max_objs + 1
        obj_verts = np.zeros((S, self.pnt_size, 3), np.float32)
        obj_verts[0] = human[: self.pnt_size]
        obj_mask = np.zeros((S,), np.float32)
        obj_cats = np.zeros((S, self.max_cats), np.float32)
        obj_cats[0, self.cat_table["human"]] = 1
        for i, obj in enumerate(given):
            obj_verts[i + 1] = all_objs[obj]
            obj_mask[i + 1] = 1
            obj_cats[i + 1, self._cat_of(obj)] = 1

        target_verts = all_objs[target]
        target_cat = np.zeros((self.max_cats,), np.float32)
        target_cat[self._cat_of(target)] = 1
        return obj_mask, obj_verts, obj_cats, target_verts, target_cat, prompt, seq


class Humanise(ProxDatasetTxt):
    """HUMANISE dataset (reference ``HUMANISE``, ``posa/dataset.py:477``)."""

    datatype = "humanise"

    def __init__(self, data_dir: str, objs_data_dir: str = "data/humanise/objs",
                 max_cats: int = 11, **kw):
        super().__init__(data_dir, objs_data_dir=objs_data_dir, max_cats=max_cats, **kw)

    def _scene_of(self, seq_name: str) -> str:
        return seq_name[:9] + "_00"  # reference :577

    def _cat_of(self, obj_name: str) -> int:
        return self.cat_table[obj_name.split("_")[0]]


class DataLoader:
    """Minimal host loader: shuffling, fixed-size batching (drop_last to keep
    shapes static), optional background prefetch thread.

    The reference uses torch DataLoader with num_workers=0
    (``run/train_sdm.py:256``); here batches are assembled in a single
    producer thread (dataset arrays are preloaded in RAM, so assembly is a
    cheap gather) and handed to the device side double-buffered.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, idxs: Sequence[int]) -> Batch:
        items = [self.dataset[i] for i in idxs]
        # pad the final short batch by repeating the last item (static shapes)
        while len(items) < self.batch_size:
            items.append(items[-1])
        masks, verts, cats, tverts, tcats, prompts, seqs = zip(*items)
        return Batch(
            mask=np.stack(masks),
            given_objs=np.stack(verts),
            given_cats=np.stack(cats),
            target_verts=np.stack(tverts),
            target_cat=np.stack(tcats),
            text=list(prompts),
            seq_names=list(seqs),
        )

    def __iter__(self) -> Iterator[Batch]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        chunks = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            chunks = [c for c in chunks if len(c) == self.batch_size]
        if self.prefetch <= 0:
            for c in chunks:
                yield self._make_batch(c)
            return

        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            try:
                for c in chunks:
                    q.put(self._make_batch(c))
            except Exception as e:  # raised in the consumer, not lost with the thread
                q.put(e)
            q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, Exception):
                raise item
            yield item
