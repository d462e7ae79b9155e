"""ImageNet and WordNet class lookups (counterpart of
``pix2latent_tpu/utils/imagenet_tools.py``).

The mappings are public ImageNet metadata (wnid <-> class index <-> noun,
the PASCAL and COCO category lists) in the package's own copy of the data
file, ``utils/data/imagenet_meta.json.gz``. The WordNet helpers
(``query_subclass_by_name`` and the hypernym walks) need ``nltk`` and its
wordnet corpus; without either they raise ``RuntimeError`` (the JAX
package raises it for a missing corpus), and the category tables fall back
to a noun search.
"""

from __future__ import annotations

import functools
import gzip
import json
import os

import numpy as np

from pix2latent_tpu_torch.utils import misc

_DATA = os.path.join(os.path.dirname(__file__), "data",
                     "imagenet_meta.json.gz")


@functools.lru_cache(maxsize=1)
def _meta():
    with gzip.open(_DATA, "rt") as f:
        return json.load(f)


def _wnid_key(wnid) -> str:
    """Normalize a wnid ('n02084071', '2084071', or int 2084071) to the
    int-string key format of the metadata table (which mirrors the
    reference's integer-keyed ``IMAGENET_WNID_TO_LABEL``,
    ``dataset_misc.py``; its ``wnid_to_synset`` accepts both forms too,
    ``imagenet_tools.py:50-57``)."""
    s = str(wnid)
    if s and s[0] == "n":
        s = s[1:]
    return str(int(s))


def wnid_to_label(wnid) -> int:
    """wnid ('n02084071' / '2084071' / 2084071) -> ImageNet class index."""
    return int(_meta()["imagenet_wnid_to_label"][_wnid_key(wnid)])


@functools.lru_cache(maxsize=1)
def _label_to_wnid_table():
    return {int(v): k for k, v in _meta()["imagenet_wnid_to_label"].items()}


def label_to_wnid(label: int) -> str:
    """ImageNet class index -> canonical 'n%08d' wnid string."""
    return "n" + _label_to_wnid_table()[int(label)].zfill(8)


def label_to_noun(label: int) -> str:
    return _meta()["imagenet_label_to_noun"][str(int(label))]


def noun_to_labels(noun: str):
    """Substring search over class nouns -> [(label, noun)]."""
    noun = noun.lower()
    return [(int(k), v) for k, v in
            _meta()["imagenet_label_to_noun"].items()
            if noun in v.lower()]


def pascal_categories():
    return list(_meta()["pascal_categories"])


def coco_categories():
    return list(_meta()["coco_categories"])


def _wordnet():
    try:
        from nltk.corpus import wordnet as wn
        wn.synsets("dog")  # force corpus load
        return wn
    except (ImportError, LookupError) as e:
        raise RuntimeError(
            "nltk or its wordnet corpus is not available (offline "
            "environment). Install nltk and run nltk.download('wordnet') "
            "when online; the static wnid/label/noun mappings above work "
            "without it.") from e


def wnid_to_synset(wnid):
    """wnid (any accepted form) -> nltk synset (reference
    ``imagenet_tools.py:50-57``, which likewise accepts 'n…'/str/int)."""
    wn = _wordnet()
    return wn.synset_from_pos_and_offset("n", int(_wnid_key(wnid)))


def synset_to_wnid(synset) -> str:
    return f"{synset.pos()}{synset.offset():08d}"


def query_subclass_by_name(name: str, verbose: bool = False):
    """All ImageNet classes that are WordNet hyponyms of ``name``
    (reference ``imagenet_tools.py:19-37``)."""
    wn = _wordnet()
    labels = []
    for syn in wn.synsets(name):
        closure = set(syn.closure(lambda s: s.hyponyms()))
        closure.add(syn)
        for s in closure:
            wnid = _wnid_key(synset_to_wnid(s))
            if wnid in _meta()["imagenet_wnid_to_label"]:
                lbl = wnid_to_label(wnid)
                labels.append(lbl)
                if verbose:
                    print(lbl, s.name())
    return sorted(set(labels))


def wnid_str_to_int(str_wnid: str) -> int:
    """'n02084071' -> 2084071 (reference ``imagenet_tools.py:60-62``)."""
    return int(str_wnid[1:].lstrip("0"))


def wnid_to_noun(wnid: str) -> str:
    """wnid -> first lemma of its synset (reference
    ``imagenet_tools.py:65-67``). Falls back to the static class-noun table
    for ImageNet wnids when the wordnet corpus is unavailable."""
    try:
        return wnid_to_synset(wnid).lemmas()[0].name().replace("_", " ")
    except RuntimeError:
        table = _meta()["imagenet_wnid_to_label"]
        key = _wnid_key(wnid)
        if key in table:
            return label_to_noun(int(table[key])).split(",")[0]
        raise


def get_parent_wnid(wnid: str) -> str:
    """wnid -> wnid of its first hypernym (reference
    ``imagenet_tools.py:40-42``)."""
    return synset_to_wnid(wnid_to_synset(wnid).hypernyms()[0])


def is_hyponym(syn1, syn2) -> bool:
    """Whether synset ``syn1`` is a descendant of ``syn2`` following first
    hypernyms (reference ``imagenet_tools.py:70-77``)."""
    while syn1 != syn2:
        hypernyms = syn1.hypernyms()
        if not hypernyms:
            return False
        syn1 = hypernyms[0]
    return True


def wnid_depth(wnid: str) -> int:
    """Depth of the wnid in the (first-parent) hypernym chain (reference
    ``imagenet_tools.py:80-90``)."""
    syn = wnid_to_synset(wnid)
    depth = 0
    while syn.hypernyms():
        depth += 1
        syn = syn.hypernyms()[0]
    return depth


def wnid_statistics(wnid_arr):
    """Depth statistics over a list of wnids (reference
    ``imagenet_tools.py:110-121``)."""
    depth_arr = [wnid_depth(w) for w in wnid_arr]
    return {"depth_arr": depth_arr,
            "min_depth": int(np.min(depth_arr)),
            "max_depth": int(np.max(depth_arr))}


def read_synset_file(synset_words_path):
    """First whitespace token per line of a synset(_words).txt (reference
    ``imagenet_tools.py:93-100``)."""
    with open(synset_words_path) as f:
        return [line.split(" ")[0] for line in f]


def read_txt_file(txt_file):
    """Lines of an imagenet train/val listing (reference
    ``imagenet_tools.py:103-107``)."""
    with open(txt_file) as f:
        return list(f)


def _valid_labels_for(names):
    labels = {}
    for n in names:
        try:
            v = query_subclass_by_name(n)
        except RuntimeError:
            v = [lbl for lbl, _ in noun_to_labels(n)]
        if v:
            labels[n] = np.sort(np.asarray(v))
    return labels


def get_coco_valid_labels():
    """COCO category -> ImageNet class indices (reference
    ``imagenet_tools.py:125-131``; labels are the working currency here —
    the reference mixed wnids and labels)."""
    return _valid_labels_for(coco_categories())


def get_pascal_valid_labels():
    """PASCAL category -> ImageNet class indices (reference
    ``imagenet_tools.py:134-140``)."""
    return _valid_labels_for(pascal_categories())


def get_coco_valid_wnids():
    """COCO category -> ImageNet wnid strings (reference name,
    ``imagenet_tools.py:125-131``); the label variant above is the working
    currency for ``to_onehot``/class-embedding lookups."""
    return {k: np.asarray([label_to_wnid(int(v)) for v in vs])
            for k, vs in get_coco_valid_labels().items()}


def get_pascal_valid_wnids():
    """PASCAL category -> ImageNet wnid strings (reference name,
    ``imagenet_tools.py:134-140``)."""
    return {k: np.asarray([label_to_wnid(int(v)) for v in vs])
            for k, vs in get_pascal_valid_labels().items()}


def coco_to_imagenet_labels(coco_name: str):
    """COCO/PASCAL category name -> candidate ImageNet class indices
    (reference ``imagenet_tools.py:125-140``): hyponym query when wordnet is
    available, noun substring match otherwise."""
    try:
        labels = query_subclass_by_name(coco_name)
        if labels:
            return labels
    except RuntimeError:
        pass
    return [lbl for lbl, _ in noun_to_labels(coco_name)]


def to_onehot(labels, num_classes=1000):
    """Class indices as a float32 one-hot tensor ``[n, num_classes]`` on
    the CPU (``utils/misc.to_onehot``)."""
    return misc.to_onehot(labels, num_classes)
