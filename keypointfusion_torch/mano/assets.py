"""Chumpy-free MANO asset loading (the port's copy of
keypointfusion_tpu/mano/assets.py, which is host numpy code).

The official MANO_{RIGHT,LEFT}.pkl files hold pickled chumpy objects. A
custom Unpickler shims every chumpy class to a state bag and the plain
numpy arrays are taken out once at load time; mano/manolayer.py:ManoLayer
then puts them on the device once. Unpickle only asset files you trust:
unpickling can run code.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Optional

import numpy as np


class _ChumpyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith('chumpy'):
            class Shim:
                def __setstate__(self, state):
                    if isinstance(state, dict):
                        self.__dict__.update(state)
                    else:
                        self.__dict__['_state'] = state
            Shim.__name__ = name
            Shim.__qualname__ = name
            return Shim
        return super().find_class(module, name)


def _to_numpy(obj) -> np.ndarray:
    """Resolve a (possibly shimmed chumpy) object to a plain numpy array."""
    if isinstance(obj, np.ndarray):
        return obj
    if hasattr(obj, 'toarray'):            # scipy sparse
        return np.asarray(obj.toarray())
    d = getattr(obj, '__dict__', {})
    if 'x' in d:                           # chumpy.Ch
        return _to_numpy(d['x'])
    if 'a' in d and 'idxs' in d:           # chumpy Select node
        base = _to_numpy(d['a']).ravel()
        out = base[np.asarray(d['idxs'])]
        shape = d.get('preferred_shape')
        return out.reshape(shape) if shape is not None else out
    raise ValueError(f"cannot resolve {type(obj).__name__} to numpy")


@dataclasses.dataclass(frozen=True)
class ManoModel:
    """Raw MANO arrays (float32). Shapes: v_template [778,3],
    shapedirs [778,3,10], posedirs [778,3,135], J_regressor [16,778],
    weights [778,16], hands_components [45,45], hands_mean [45],
    kintree_parents (16,), faces [1538,3]."""
    v_template: np.ndarray
    shapedirs: np.ndarray
    posedirs: np.ndarray
    J_regressor: np.ndarray
    weights: np.ndarray
    hands_components: np.ndarray
    hands_mean: np.ndarray
    kintree_parents: np.ndarray
    faces: np.ndarray
    side: str = 'right'

    @property
    def tip_vertex_ids(self):
        # thumb, index, middle, ring, pinky tip vertices
        # (reference manolayer.py:250-253)
        return [745, 317, 444, 556, 673] if self.side == 'right' \
            else [745, 317, 445, 556, 673]


def load_mano_model(pkl_path: str, side: Optional[str] = None) -> ManoModel:
    with open(pkl_path, 'rb') as f:
        dd = _ChumpyUnpickler(f, encoding='latin1').load()
    if side is None:
        side = 'left' if 'LEFT' in pkl_path.upper() else 'right'
    f32 = lambda k: _to_numpy(dd[k]).astype(np.float32)
    return ManoModel(
        v_template=f32('v_template'),
        shapedirs=f32('shapedirs'),
        posedirs=f32('posedirs'),
        J_regressor=f32('J_regressor'),
        weights=f32('weights'),
        hands_components=f32('hands_components'),
        hands_mean=f32('hands_mean'),
        kintree_parents=np.asarray(dd['kintree_table'])[0].astype(np.int32),
        faces=_to_numpy(dd['f']).astype(np.int32),
        side=side,
    )


def synthetic_mano_model(seed: int = 0) -> ManoModel:
    """A random MANO-shaped asset for tests when the real pkl is absent,
    the JAX package's function. Its skinning weights are rows of uniform
    draws that do not sum to 1, so skinning with it is not rigid under a
    global rotation: normalise the rows for checks that need that."""
    rng = np.random.RandomState(seed)
    Jr = np.abs(rng.rand(16, 778)).astype(np.float32)
    Jr /= Jr.sum(-1, keepdims=True)
    return ManoModel(
        v_template=rng.randn(778, 3).astype(np.float32) * 0.01,
        shapedirs=rng.randn(778, 3, 10).astype(np.float32) * 0.001,
        posedirs=rng.randn(778, 3, 135).astype(np.float32) * 0.001,
        J_regressor=Jr,
        weights=np.abs(rng.rand(778, 16)).astype(np.float32),
        hands_components=rng.randn(45, 45).astype(np.float32),
        hands_mean=np.zeros(45, np.float32),
        kintree_parents=np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11,
                                  0, 13, 14], np.int32),
        faces=np.zeros((1538, 3), np.int32),
    )
