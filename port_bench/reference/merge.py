"""The class merge of "Automated Deep Photo Style Transfer" (arXiv:1901.03915,
§3.2), plainly, on the host: the content's and the style's ADE20K label maps
hold different classes; each class found in one map only goes to the most
similar class found in both, by the similarity of their label names, where
that similarity reaches a threshold, and else to the largest shared class;
the shared classes are then folded, the smallest first into its most
similar survivor, until `max_classes` are left; each map's masks are one-hot
over the survivors, zero-padded to `max_classes`.

The "grouped" similarity: 1 between a class and itself, 0.8 between two
classes of one curated semantic group of ADE20K's labels, 0 otherwise. The
150 labels and the groups are data, copied here.

Ties: the shared classes are ranked by their pixels in both maps, largest
first, equal counts in the order of the set of shared ids; a fold takes
the first smallest in that order, and the first most similar survivor, the
larger one among equals; the survivors come out largest first.
"""
from __future__ import annotations

import numpy as np

# ADE20K's scene-parsing classes in the order of the head's outputs; each
# named by its first synonym
LABELS = (
    "wall", "building", "sky", "floor", "tree", "ceiling", "road", "bed",
    "windowpane", "grass", "cabinet", "sidewalk", "person", "earth", "door",
    "table", "mountain", "plant", "curtain", "chair", "car", "water",
    "painting", "sofa", "shelf", "house", "sea", "mirror", "rug", "field",
    "armchair", "seat", "fence", "desk", "rock", "wardrobe", "lamp",
    "bathtub", "railing", "cushion", "base", "box", "column", "signboard",
    "chest of drawers", "counter", "sand", "sink", "skyscraper",
    "fireplace", "refrigerator", "grandstand", "path", "stairs", "runway",
    "case", "pool table", "pillow", "screen door", "stairway", "river",
    "bridge", "bookcase", "blind", "coffee table", "toilet", "flower",
    "book", "hill", "bench", "countertop", "stove", "palm",
    "kitchen island", "computer", "swivel chair", "boat", "bar",
    "arcade machine", "hovel", "bus", "towel", "light", "truck", "tower",
    "chandelier", "awning", "streetlight", "booth", "television",
    "airplane", "dirt track", "apparel", "pole", "land", "bannister",
    "escalator", "ottoman", "bottle", "buffet", "poster", "stage", "van",
    "ship", "fountain", "conveyer belt", "canopy", "washer", "plaything",
    "swimming pool", "stool", "barrel", "basket", "waterfall", "tent",
    "bag", "minibike", "cradle", "oven", "ball", "food", "step", "tank",
    "trade name", "microwave", "pot", "animal", "bicycle", "lake",
    "dishwasher", "screen", "blanket", "sculpture", "hood", "sconce",
    "vase", "traffic light", "tray", "ashcan", "fan", "pier", "crt screen",
    "plate", "monitor", "bulletin board", "shower", "radiator", "glass",
    "clock", "flag",
)
# The semantic groups; a label named by two groups ("mirror") is held by
# the later one
GROUPS = (
    ("sky",),
    ("water", "sea", "river", "lake", "waterfall", "swimming pool",
     "fountain"),
    ("tree", "grass", "plant", "flower", "palm", "field"),
    ("floor", "earth", "road", "sidewalk", "path", "sand", "hill", "land",
     "dirt track", "runway", "rug"),
    ("mountain", "rock"),
    ("building", "house", "skyscraper", "tower", "hovel", "booth", "tent",
     "bridge", "grandstand", "stage", "fireplace", "wall", "fence",
     "column", "bannister", "railing", "step", "stairs", "stairway",
     "escalator", "pier", "awning", "canopy", "hood"),
    ("ceiling",),
    ("person",),
    ("animal",),
    ("car", "bus", "truck", "van", "boat", "ship", "airplane", "bicycle",
     "minibike", "conveyer belt"),
    ("bed", "cabinet", "table", "chair", "sofa", "shelf", "armchair",
     "seat", "desk", "wardrobe", "cushion", "chest of drawers", "counter",
     "case", "pool table", "pillow", "bookcase", "coffee table", "bench",
     "countertop", "kitchen island", "swivel chair", "bar", "ottoman",
     "buffet", "stool", "cradle", "basket", "barrel", "box", "pot", "base"),
    ("door", "windowpane", "screen door", "blind", "curtain", "mirror",
     "shower"),
    ("lamp", "light", "chandelier", "streetlight", "sconce",
     "traffic light"),
    ("refrigerator", "stove", "oven", "microwave", "washer", "dishwasher",
     "sink", "bathtub", "toilet", "radiator", "fan", "computer",
     "television", "crt screen", "monitor", "screen", "arcade machine"),
    ("painting", "poster", "sculpture", "vase", "clock", "bulletin board",
     "signboard", "trade name", "flag", "mirror"),
    ("book", "bottle", "towel", "apparel", "bag", "plaything", "ball",
     "food", "tray", "plate", "glass", "blanket", "ashcan", "pole", "tank"),
)
N = len(LABELS)


def grouped_similarity() -> np.ndarray:
    """(150, 150) float32: 1 on the diagonal, 0.8 within a group."""
    group = {}
    for g, members in enumerate(GROUPS):
        for name in members:
            group[name] = g
    ids = np.array([group.get(name, -1) for name in LABELS])
    same = (ids[:, None] == ids[None, :]) & (ids[:, None] >= 0)
    sim = np.where(same, 0.8, 0.0).astype(np.float32)
    np.fill_diagonal(sim, 1.0)
    return sim


def merge(seg_c: np.ndarray, seg_s: np.ndarray, threshold: float,
          max_classes: int) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """(content labels, style labels, surviving class ids) of two label
    maps under the grouped similarity."""
    sim = grouped_similarity()
    ids_c, n_c = np.unique(seg_c, return_counts=True)
    ids_s, n_s = np.unique(seg_s, return_counts=True)
    pixels = np.zeros(N, np.int64)
    pixels[ids_c] += n_c
    pixels[ids_s] += n_s
    in_c, in_s = set(ids_c.tolist()), set(ids_s.tolist())
    shared = sorted(in_c & in_s, key=lambda i: -pixels[i])
    into = np.arange(N)
    if not shared:
        # nothing in common: one class, the largest, for every pixel
        into[:] = int(np.argmax(pixels))
        shared = [int(into[0])]
    else:
        for cid in in_c ^ in_s:
            near = sim[cid, shared]
            best = int(np.argmax(near))
            into[cid] = shared[best] if near[best] >= threshold else shared[0]

    def sizes() -> np.ndarray:
        out = np.zeros(N, np.int64)
        np.add.at(out, into, pixels)
        return out

    kept = list(shared)
    while len(kept) > max_classes:
        size = sizes()
        smallest = min(kept, key=lambda i: size[i])
        kept.remove(smallest)
        target = max(kept, key=lambda i: (sim[smallest, i], size[i]))
        into[into == smallest] = target
    size = sizes()
    kept.sort(key=lambda i: -size[i])
    return into[seg_c], into[seg_s], kept


def one_hot(labels: np.ndarray, class_ids: list[int], k: int) -> np.ndarray:
    """(k, H, W) float32 masks of `class_ids` in order, zero-padded."""
    masks = np.zeros((k, *labels.shape), np.float32)
    for j, cid in enumerate(class_ids):
        masks[j] = labels == cid
    return masks
