"""Semantic class merging for segmentation mask alignment (host numpy).

The port's copy of `dpst_tpu/semantic_merge.py` (paper §3.2 of
arXiv:1901.03915): the content and style label maps generally contain
different ADE20K classes; classes present in only one image are merged
into the most semantically similar class present in both, gated by a
similarity threshold, and the shared set is reduced to `max_classes`. The
label-name similarity is a 150×150 matrix: the built-in one is a curated
semantic grouping of the ADE20K label set plus token overlap (no file),
or an external matrix asset ($DPST_SIMILARITY_MATRIX or
weights/similarity_matrix.npz).

Everything here is O(150²) label math on the host, run once per pair; it
imports neither torch nor anything of the JAX package, and its tables and
order of operations are the JAX package's, so equal label maps merge to
equal labels.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

# The 150 ADE20K scene-parsing classes, in benchmark order (index = class
# id as produced by the PSPNet head). Synonyms separated by "|".
ADE20K_LABELS = (
    "wall", "building|edifice", "sky", "floor|flooring", "tree",
    "ceiling", "road|route", "bed", "windowpane|window", "grass",
    "cabinet", "sidewalk|pavement", "person|human", "earth|ground",
    "door", "table", "mountain|mount", "plant|flora", "curtain|drape",
    "chair", "car|auto", "water", "painting|picture", "sofa|couch",
    "shelf", "house", "sea", "mirror", "rug|carpet", "field",
    "armchair", "seat", "fence|fencing", "desk", "rock|stone",
    "wardrobe|closet", "lamp", "bathtub|bath", "railing|rail",
    "cushion", "base|pedestal", "box", "column|pillar",
    "signboard|sign", "chest of drawers|dresser", "counter", "sand",
    "sink", "skyscraper", "fireplace|hearth", "refrigerator|icebox",
    "grandstand|stand", "path", "stairs|steps", "runway",
    "case|showcase", "pool table|billiard table", "pillow",
    "screen door|screen", "stairway|staircase", "river", "bridge|span",
    "bookcase", "blind|screen", "coffee table", "toilet|can",
    "flower", "book", "hill", "bench", "countertop", "stove",
    "palm|palm tree", "kitchen island", "computer", "swivel chair",
    "boat", "bar", "arcade machine", "hovel|hut", "bus", "towel",
    "light", "truck", "tower", "chandelier", "awning|sunshade",
    "streetlight|street lamp", "booth|cubicle", "television|tv",
    "airplane|aeroplane", "dirt track", "apparel|clothes", "pole",
    "land|soil", "bannister|banister", "escalator", "ottoman|pouf",
    "bottle", "buffet|sideboard", "poster|placard", "stage", "van",
    "ship", "fountain", "conveyer belt|conveyor", "canopy",
    "washer|washing machine", "plaything|toy", "swimming pool|pool",
    "stool", "barrel|cask", "basket", "waterfall|falls", "tent",
    "bag", "minibike|motorbike", "cradle", "oven", "ball",
    "food|solid food", "step|stair", "tank|storage tank",
    "trade name|brand", "microwave", "pot|flowerpot",
    "animal|animate being", "bicycle|bike", "lake", "dishwasher",
    "screen|projection screen", "blanket|cover", "sculpture", "hood",
    "sconce", "vase", "traffic light|stoplight", "tray",
    "ashcan|trash can", "fan", "pier|wharf", "crt screen", "plate",
    "monitor|monitoring device", "bulletin board|notice board",
    "shower", "radiator", "glass|drinking glass", "clock", "flag",
)
N_CLASSES = len(ADE20K_LABELS)
assert N_CLASSES == 150

# Curated semantic grouping: classes in the same group are strong merge
# candidates (the paper's "semantically similar" notion). Names refer to
# the FIRST synonym above.
_GROUPS = {
    "sky": ["sky"],
    "water": ["water", "sea", "river", "lake", "waterfall",
              "swimming pool", "fountain"],
    "vegetation": ["tree", "grass", "plant", "flower", "palm", "field"],
    "ground": ["floor", "earth", "road", "sidewalk", "path", "sand",
               "hill", "land", "dirt track", "runway", "rug"],
    "mountain": ["mountain", "rock"],
    "building": ["building", "house", "skyscraper", "tower", "hovel",
                 "booth", "tent", "bridge", "grandstand", "stage",
                 "fireplace", "wall", "fence", "column", "bannister",
                 "railing", "step", "stairs", "stairway", "escalator",
                 "pier", "awning", "canopy", "hood"],
    "ceiling": ["ceiling"],
    "person": ["person"],
    "animal": ["animal"],
    "vehicle": ["car", "bus", "truck", "van", "boat", "ship",
                "airplane", "bicycle", "minibike", "conveyer belt"],
    "furniture": ["bed", "cabinet", "table", "chair", "sofa", "shelf",
                  "armchair", "seat", "desk", "wardrobe", "cushion",
                  "chest of drawers", "counter", "case", "pool table",
                  "pillow", "bookcase", "coffee table", "bench",
                  "countertop", "kitchen island", "swivel chair", "bar",
                  "ottoman", "buffet", "stool", "cradle", "basket",
                  "barrel", "box", "pot", "base"],
    "door_window": ["door", "windowpane", "screen door", "blind",
                    "curtain", "mirror", "shower"],
    "lighting": ["lamp", "light", "chandelier", "streetlight", "sconce",
                 "traffic light"],
    "appliance": ["refrigerator", "stove", "oven", "microwave", "washer",
                  "dishwasher", "sink", "bathtub", "toilet", "radiator",
                  "fan", "computer", "television", "crt screen",
                  "monitor", "screen", "arcade machine"],
    "decor": ["painting", "poster", "sculpture", "vase", "clock",
              "bulletin board", "signboard", "trade name", "flag",
              "mirror"],
    "stuff": ["book", "bottle", "towel", "apparel", "bag", "plaything",
              "ball", "food", "tray", "plate", "glass", "blanket",
              "ashcan", "pole", "tank"],
}
_PRIMARY = {lbl.split("|")[0]: i for i, lbl in enumerate(ADE20K_LABELS)}
_GROUP_OF = np.full(N_CLASSES, -1, np.int32)
for _gi, (_gname, _members) in enumerate(_GROUPS.items()):
    for _m in _members:
        if _m in _PRIMARY:
            _GROUP_OF[_PRIMARY[_m]] = _gi


def _token_sim(a: str, b: str) -> float:
    """Jaccard similarity over word tokens + char-trigram fallback of all
    synonym spellings — catches e.g. "coffee table"~"table"."""
    ta = set(t for s in a.split("|") for t in s.split())
    tb = set(t for s in b.split("|") for t in s.split())
    word = len(ta & tb) / max(len(ta | tb), 1)

    def grams(s):
        s = s.replace("|", " ")
        return {s[i:i + 3] for i in range(max(len(s) - 2, 1))}

    ga, gb = grams(a), grams(b)
    tri = len(ga & gb) / max(len(ga | gb), 1)
    return max(word, tri)


def _external_matrix() -> np.ndarray | None:
    """Drop-in similarity-matrix asset (the paper's word-embedding /
    WordNet metrics): a 150×150 `.npz`/`.npy` pointed to
    by $DPST_SIMILARITY_MATRIX (or weights/similarity_matrix.npz) — e.g.
    cosine similarities of label-name embeddings computed offline.
    Loaded once; rows/cols follow ADE20K benchmark class order."""
    import os
    path = os.environ.get(
        "DPST_SIMILARITY_MATRIX",
        os.path.join(os.path.dirname(__file__), "..", "weights",
                     "similarity_matrix.npz"))
    if not (path and os.path.exists(path)):
        return None
    data = np.load(path)
    arr = data["similarity"] if hasattr(data, "files") else data
    arr = np.asarray(arr, np.float32)
    if arr.shape != (N_CLASSES, N_CLASSES):
        raise ValueError(
            f"similarity matrix asset {path}: expected "
            f"({N_CLASSES}, {N_CLASSES}), got {arr.shape}")
    if not np.allclose(arr, arr.T, atol=1e-5):
        raise ValueError(f"similarity matrix asset {path}: not symmetric")
    # normalize into [0, 1] so the threshold semantics match the
    # built-in metrics (embeddings often give cosine in [-1, 1])
    lo, hi = float(arr.min()), float(arr.max())
    if lo < 0.0 or hi > 1.0:
        arr = (arr - lo) / max(hi - lo, 1e-9)
    np.fill_diagonal(arr, 1.0)
    return arr


def similarity_matrix(metric: str = "grouped") -> np.ndarray:
    """(150, 150) symmetric label-name similarity in [0, 1].

    "embedding": an external precomputed matrix asset
                 ($DPST_SIMILARITY_MATRIX — the paper's word-embedding
                 metric, shipped like the weight bundles). Requires the
                 asset; raises otherwise.
    "grouped": 1 on the diagonal, 0.8 within a curated semantic group.
    "token":   lexical overlap of the label names.
    "combined" (default behavior of `merge_classes` via cfg): max of both.

    If the external asset exists it also TAKES PRECEDENCE for the
    built-in metric names, matching the original system's behavior of using
    its downloaded embedding table when present. The asset is re-checked
    per call (it is a 90 KB load, off the hot path); the built-in
    computation is cached.
    """
    if metric not in ("grouped", "token", "combined", "embedding"):
        raise ValueError(f"unknown similarity metric {metric!r}")
    ext = _external_matrix()
    if metric == "embedding":
        if ext is None:
            raise FileNotFoundError(
                "similarity_metric='embedding' needs a 150x150 matrix "
                "asset (set $DPST_SIMILARITY_MATRIX or add "
                "weights/similarity_matrix.npz)")
        return ext
    if ext is not None:
        return ext
    return _builtin_matrix(metric)


@lru_cache(maxsize=None)
def _builtin_matrix(metric: str) -> np.ndarray:
    sim = np.eye(N_CLASSES, dtype=np.float32)
    if metric in ("grouped", "combined"):
        same = (_GROUP_OF[:, None] == _GROUP_OF[None, :]) & (
            _GROUP_OF[:, None] >= 0)
        sim = np.maximum(sim, np.where(same, 0.8, 0.0)).astype(np.float32)
    if metric in ("token", "combined"):
        tok = np.zeros((N_CLASSES, N_CLASSES), np.float32)
        for i in range(N_CLASSES):
            for j in range(i + 1, N_CLASSES):
                tok[i, j] = tok[j, i] = _token_sim(
                    ADE20K_LABELS[i], ADE20K_LABELS[j])
        sim = np.maximum(sim, tok)
    return sim


def merge_classes(seg_c: np.ndarray, seg_s: np.ndarray,
                  metric: str = "grouped", threshold: float = 0.25,
                  max_classes: int = 8
                  ) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """Align the two label maps onto a shared merged class set.

    Classes present in only one map are relabeled to the most similar
    class present in BOTH (paper §3.2); below `threshold` they fall back
    to the globally largest shared class. The shared set is then greedily
    reduced to `max_classes` by merging the smallest class into its most
    similar survivor (a fixed class axis for the mask stacks).

    Returns (merged_content_map, merged_style_map, class_ids) with
    class_ids sorted by combined pixel area, descending.
    """
    seg_c = np.asarray(seg_c)
    seg_s = np.asarray(seg_s)
    sim = similarity_matrix(metric)

    ids_c, cnt_c = np.unique(seg_c, return_counts=True)
    ids_s, cnt_s = np.unique(seg_s, return_counts=True)
    area = np.zeros(N_CLASSES, np.int64)
    area[ids_c] += cnt_c
    area[ids_s] += cnt_s
    common = sorted(set(ids_c.tolist()) & set(ids_s.tolist()),
                    key=lambda i: -area[i])

    remap = np.arange(N_CLASSES, dtype=np.int64)
    if not common:
        # disjoint label sets: collapse everything onto the overall
        # largest class — a single global style mask
        target = int(np.argmax(area))
        remap[:] = target
        common = [target]
    else:
        fallback = common[0]
        for cid in set(ids_c.tolist()) ^ set(ids_s.tolist()):
            sims = sim[cid, common]
            best = int(np.argmax(sims))
            remap[cid] = common[best] if sims[best] >= threshold \
                else fallback

    # reduce to max_classes: smallest merged class folds into its most
    # similar surviving class (by label similarity, area as tiebreak)
    def merged_area(ids):
        a = np.zeros(N_CLASSES, np.int64)
        for src in range(N_CLASSES):
            a[remap[src]] += area[src]
        return {i: int(a[i]) for i in ids}

    kept = list(common)
    while len(kept) > max_classes:
        areas = merged_area(kept)
        smallest = min(kept, key=lambda i: areas[i])
        rest = [i for i in kept if i != smallest]
        target = max(rest, key=lambda i: (sim[smallest, i], areas[i]))
        remap[remap == smallest] = target
        kept = rest

    areas = merged_area(kept)
    class_ids = sorted(kept, key=lambda i: -areas[i])
    return remap[seg_c], remap[seg_s], class_ids
