"""Ray blocks that are hostile to the block cull (kernel K1), shared by the
CPU parity tests and the card tests. Numpy only: the card's machine has no
jax."""
import numpy as np

BLOCK = 128


def hostile_rays8(seed: int, nr: int, boxes: np.ndarray) -> np.ndarray:
    """(nr*128, 8) f32 rays [o(3), d(3), t_min, t_max] in blocks of 128, made
    from a seed. `boxes` is an (8, M) table [cx cy cz r hx hy hz .]. Blocks
    cycle through eight kinds:
      0 ordinary rays                 4 every ray dead (t_max <= t_min)
      1 NaN origins and directions    5 t_max equal to, below, infinite, NaN
      2 infinite origins, directions  6 origins at box centres, faces, corners
      3 zero direction components     7 one live ray per 16-ray sub-block
    """
    rng = np.random.default_rng(seed)
    n = nr * BLOCK
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.full(n, 1e-3, np.float32)
    t_max = rng.uniform(0.5, 12, n).astype(np.float32)
    lane = np.arange(BLOCK)
    m = boxes.shape[1]
    for b in range(nr):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        ob, db, tm, tM = o[sl], d[sl], t_min[sl], t_max[sl]
        kind = b % 8
        if kind == 1:
            ob[lane % 7 == 0, rng.integers(0, 3)] = np.nan
            db[lane % 5 == 1, rng.integers(0, 3)] = np.nan
            ob[lane % 31 == 2] = np.nan
        elif kind == 2:
            ob[lane % 6 == 0, 0] = np.inf
            ob[lane % 6 == 1, 1] = -np.inf
            db[lane % 6 == 2, 2] = np.inf
            db[lane % 6 == 3] = -np.inf
            ob[lane % 9 == 4] = 3e38
            tM[lane % 4 == 0] = np.inf
        elif kind == 3:
            db[lane % 4 == 0, 0] = 0.0
            db[lane % 4 == 1, 1:] = 0.0
            db[lane % 8 == 2] = 0.0
            db[lane % 8 == 3, 2] = -0.0
            db[lane % 8 == 7, 1] = 1e-38
        elif kind == 4:
            tM[:] = np.where(lane % 2 == 0, 0.0, tm)
        elif kind == 5:
            tM[lane % 5 == 0] = tm[lane % 5 == 0]
            tM[lane % 5 == 1] = -1.0
            tM[lane % 5 == 2] = np.inf
            tM[lane % 5 == 3] = np.nan
            tm[lane % 10 == 4] = np.nan
        elif kind == 6:
            col = rng.integers(0, m, BLOCK)
            corner = np.sign(rng.normal(size=(BLOCK, 3))).astype(np.float32)
            corner[lane % 3 == 0] = 0.0  # the centre itself
            corner[lane % 3 == 1, 1:] = 0.0  # a face centre
            ob[:] = boxes[0:3, col].T + corner * boxes[4:7, col].T
        elif kind == 7:
            tM[lane % 16 != (3 * b) % 16] = 0.0
    return np.concatenate([o, d, t_min[:, None], t_max[:, None]], axis=1).astype(np.float32)
