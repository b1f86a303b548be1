"""Problem frontends, a NumPy/SciPy copy of tnax's: Ising (quasi-2D block
lattices, e.g. chimera) and RMF (random Markov fields).

Counterpart of ``tnax/problems.py``: host preprocessing that turns
couplings into per-site *energy tables*, which the PEPS factory
(`tnax_torch.engine.peps_rows`) and the exact energy bookkeeping consume.
It is copied rather than imported because importing ``tnax`` imports and
configures jax, and the port runs where jax is absent.

A lattice site (block of spins, or one RMF variable) is described by
:class:`SiteTables`:

    W[s, l, d, r, u] = exp(beta*(offsets - Es[s] - Esl[s, l] - Esu[s, u]))
                       * delta(d == dmap[s]) * delta(r == rmap[s])

Bit/spin conventions (as tnax, for golden parity):
  - block state ``s`` is an integer; spin ``i`` of the block is *up* (+1)
    when bit ``i`` of ``s`` is 0, *down* (-1) when the bit is 1 ("first
    spin changes fastest").
  - a leg index is the integer formed by the bits of the boundary-spin
    subset (in ascending block-spin order), same 0/1 convention.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse


# ---------------------------------------------------------------------------
# coupling-file utilities (reference tnac4o/auxx.py:24-79)
# ---------------------------------------------------------------------------

def load_Jij(file_name):
    """Load `i j Jij` triples from a text file (one coupling per line)."""
    data = np.loadtxt(file_name)
    return [[int(r[0]), int(r[1]), float(r[2])] for r in np.atleast_2d(data)]


def round_Jij(J, dJ):
    """Round couplings to integer multiples of ``dJ``."""
    dJ = float(dJ)
    return [[i, j, round(v / dJ) * dJ] for i, j, v in J]


def minus_Jij(J):
    """Flip the sign of all couplings (max <-> min)."""
    return [[i, j, -v] for i, j, v in J]


def Jij_f2p(J):
    """Convert 1-based spin indices to 0-based."""
    return [[i - 1, j - 1, v] for i, j, v in J]


def couplings_to_sparse(J, L):
    """Upper-triangular sparse coupling matrix from a triple list.

    Symmetric entries are folded into the upper triangle
    (reference `tnac4o/tnac4o.py:176-181`).
    """
    ii, jj, vv = zip(*J)
    JJ = scipy.sparse.coo_matrix((vv, (ii, jj)), shape=(L, L))
    JJ = scipy.sparse.triu(JJ) + scipy.sparse.tril(JJ, -1).T
    return JJ.astype(dtype=float, copy=False).tocsr()


# ---------------------------------------------------------------------------
# independent energy verifiers (reference tnac4o/auxx.py:82-133)
# ---------------------------------------------------------------------------

def energy_Jij(J, states):
    """Ising energies of bit-string states (1=up/+1, 0=down/-1).

    Independent of the solver path; used as a test oracle. The quadratic
    term contracts through the SPARSE upper triangle (s_i J_ij s_j as one
    sparse @ dense product): the earlier dense einsum cost ~8.5 s per
    1024-state re-score at chimera-2048 — it was most of the conformance
    sweeps' per-instance 'decode' time once the droplet unpack went
    native."""
    L = len(states[0])
    JJ = couplings_to_sparse(J, L)
    Jup = scipy.sparse.triu(JJ, 1)
    diag = JJ.diagonal()
    st = 2.0 * np.asarray(states, dtype=np.float64) - 1
    return np.einsum("sl,sl->s", st, Jup.dot(st.T).T) + st @ diag


def energy_RMF(J, states):
    """RMF cost of configurations given the factor dictionary ``J``."""
    states = np.asarray(states)
    eng = np.zeros(len(states))
    for key, val in J["fac"].items():
        if len(key) == 2:
            ny, nx = key
            eng += J["fun"][val][states[:, ny * J["Nx"] + nx]]
        else:
            ny1, nx1, ny2, nx2 = key
            eng += J["fun"][val][states[:, ny1 * J["Nx"] + nx1],
                                 states[:, ny2 * J["Nx"] + nx2]]
    return eng


# ---------------------------------------------------------------------------
# bit helpers
# ---------------------------------------------------------------------------

def block_spins(n_spins: int) -> np.ndarray:
    """(2**n, n) array of spins in {-1, +1}; spin i = +1 iff bit i == 0.

    Matches reference `_cluster_configurations` composed with 2*conf-1
    (reference `tnac4o/tnac4o.py:1461-1467`).
    """
    k = np.arange(2 ** n_spins, dtype=np.int64)
    bits = (k[:, None] >> np.arange(n_spins)[None, :]) & 1
    return (1 - 2 * bits).astype(np.int64)


def block_bits(n_spins: int) -> np.ndarray:
    """(2**n, n) array of bits of the state index (bit i of state k)."""
    k = np.arange(2 ** n_spins, dtype=np.int64)
    return ((k[:, None] >> np.arange(n_spins)[None, :]) & 1).astype(np.int64)


def compress_bits(positions: np.ndarray, n_spins: int) -> np.ndarray:
    """Map every block state to the integer formed by its bits at `positions`.

    This is the leg-index map (reference `_ind_bond_down`/`_ind_bond_right`,
    `tnac4o/tnac4o.py:1469-1489`).
    """
    bits = block_bits(n_spins)[:, positions] if len(positions) else \
        np.zeros((2 ** n_spins, 0), dtype=np.int64)
    weights = (1 << np.arange(len(positions), dtype=np.int64))
    return bits @ weights


# ---------------------------------------------------------------------------
# per-site tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SiteTables:
    """Energy tables and copy-leg maps of one lattice site.

    Attributes:
      n:     number of block states.
      Es:    (n,) intra-block energy.
      Esl:   (n, nl) energy of couplings to the left neighbour, columns indexed
             by the left-leg index.
      Esu:   (n, nu) energy of couplings to the up neighbour.
      dmap:  (n,) down-leg index of each state.
      rmap:  (n,) right-leg index of each state.
      nl, nd, nr, nu: leg dimensions (left, down, right, up).
    """
    n: int
    Es: np.ndarray
    Esl: np.ndarray
    Esu: np.ndarray
    dmap: np.ndarray
    rmap: np.ndarray
    nl: int
    nd: int
    nr: int
    nu: int


class Problem:
    """Base for lattice problems: grid of SiteTables + decode metadata."""

    mode: str
    Ny: int
    Nx: int

    def site(self, ny: int, nx: int) -> SiteTables:
        raise NotImplementedError


class IsingProblem(Problem):
    """Ising-type problem on an Ny x Nx lattice of blocks of Nc spins.

    Spin index convention ``i = ny*Nx*Nc + nx*Nc + m``
    (reference `tnac4o/tnac4o.py:91-92`).
    """

    mode = "Ising"

    def __init__(self, Nx: int, Ny: int, Nc: int, J=None, Jsparse=None):
        self.Nx = Nx
        self.Ny = Ny
        self.Nc = Nc
        self.L = Nx * Ny * Nc
        if Jsparse is not None:
            self.J = Jsparse
        elif J is not None:
            self.J = couplings_to_sparse(J, self.L)
        else:
            self.J = scipy.sparse.csr_matrix((self.L, self.L))
        self._build()

    # -- construction -------------------------------------------------------
    def _build(self):
        """Active-spin detection + per-block coupling decomposition.

        Semantics of reference `_divide_couplings`
        (`tnac4o/tnac4o.py:1391-1445`).
        """
        Ny, Nx, Nc = self.Ny, self.Nx, self.Nc
        Jd = self.J  # csr
        absJ = abs(Jd)
        row_sum = np.asarray(absJ.sum(axis=1)).ravel()
        col_sum = np.asarray(absJ.sum(axis=0)).ravel()
        tot = row_sum + col_sum

        self.ind = [[None] * Nx for _ in range(Ny)]   # active spin global ids
        self.sN = np.zeros((Ny, Nx), dtype=int)       # active spins per block
        self.N = np.ones((Ny, Nx), dtype=int)         # states per block
        for ny in range(Ny):
            for nx in range(Nx):
                base = Nc * (Nx * ny + nx)
                ids = base + np.arange(Nc)
                act = ids[tot[ids] > 1e-12]
                self.ind[ny][nx] = act
                self.sN[ny, nx] = len(act)
                self.N[ny, nx] = 2 ** len(act)
        self.active = int(self.sN.sum())

        # couplings: Jin intra-block, Jl to left neighbour, Ju to up neighbour
        self.Jin = [[None] * Nx for _ in range(Ny)]
        self.Jl = [[None] * Nx for _ in range(Ny)]
        self.Ju = [[None] * Nx for _ in range(Ny)]
        # positions *within the neighbour's active-spin list* that carry
        # couplings rightwards / downwards
        self.ir = [[np.zeros(0, dtype=int)] * Nx for _ in range(Ny)]
        self.id = [[np.zeros(0, dtype=int)] * Nx for _ in range(Ny)]
        self.sl = np.zeros((Ny, Nx), dtype=int)
        self.sr = np.zeros((Ny, Nx), dtype=int)
        self.su = np.zeros((Ny, Nx), dtype=int)
        self.sd = np.zeros((Ny, Nx), dtype=int)

        Jarr = self.J.tocsc()
        for ny in range(Ny):
            for nx in range(Nx):
                act = self.ind[ny][nx]
                self.Jin[ny][nx] = self.J[act, :][:, act].toarray() \
                    if len(act) else np.zeros((0, 0))
                if nx > 0:
                    left = self.ind[ny][nx - 1]
                    JJ = self.J[left, :][:, act].toarray() \
                        if len(left) and len(act) else np.zeros((len(left), len(act)))
                    nz = np.nonzero(np.sum(np.abs(JJ), axis=1))[0]
                    self.Jl[ny][nx] = JJ[nz].T          # (sN, sl)
                    self.ir[ny][nx - 1] = nz
                    self.sr[ny, nx - 1] = len(nz)
                    self.sl[ny, nx] = len(nz)
                else:
                    self.Jl[ny][nx] = np.zeros((self.sN[ny, nx], 0))
                if ny > 0:
                    up = self.ind[ny - 1][nx]
                    JJ = self.J[up, :][:, act].toarray() \
                        if len(up) and len(act) else np.zeros((len(up), len(act)))
                    nz = np.nonzero(np.sum(np.abs(JJ), axis=1))[0]
                    self.Ju[ny][nx] = JJ[nz].T          # (sN, su)
                    self.id[ny - 1][nx] = nz
                    self.sd[ny - 1, nx] = len(nz)
                    self.su[ny, nx] = len(nz)
                else:
                    self.Ju[ny][nx] = np.zeros((self.sN[ny, nx], 0))
        del Jarr

        # leg dimensions
        self.ld = 2 ** self.sd
        self.lr = 2 ** self.sr
        self.ll = 2 ** self.sl
        self.lu = 2 ** self.su

        self._site_cache = {}
        # padded-grid / device-table caches (engine.pad_grid,
        # ContractionContext._build_device_tensors) key off these
        self._grid_cache = None
        self._energy_rows_np = None

    # -- tables -------------------------------------------------------------
    def site(self, ny: int, nx: int) -> SiteTables:
        key = (ny, nx)
        if key in self._site_cache:
            return self._site_cache[key]
        sN = self.sN[ny, nx]
        st = block_spins(sN).astype(float)
        Jin = self.Jin[ny][nx]
        Es = np.einsum("si,ij,sj->s", st, np.triu(Jin, 1), st) + st @ np.diag(Jin)
        extl = block_spins(self.sl[ny, nx]).astype(float).T
        Esl = (st @ self.Jl[ny][nx]) @ extl
        extu = block_spins(self.su[ny, nx]).astype(float).T
        Esu = (st @ self.Ju[ny][nx]) @ extu
        tab = SiteTables(
            n=2 ** sN, Es=Es, Esl=Esl, Esu=Esu,
            dmap=compress_bits(self.id[ny][nx], sN),
            rmap=compress_bits(self.ir[ny][nx], sN),
            nl=self.ll[ny, nx], nd=self.ld[ny, nx],
            nr=self.lr[ny, nx], nu=self.lu[ny, nx],
        )
        self._site_cache[key] = tab
        return tab

    # -- mutation -----------------------------------------------------------
    def rotate(self):
        """Rotate the lattice 90 degrees (reference
        `tnac4o/tnac4o.py:297-313`).

        Returns ``order_i`` with ``order_i[jj] = ii`` for cluster positions
        ``ii`` (pre-rotation linear index) and ``jj`` (post-rotation linear
        index), as the reference defines it; the solver composes
        cumulative orders with it.
        """
        Nx, Ny, Nc = self.Nx, self.Ny, self.Nc
        order_full = np.arange(self.L)
        order_i = np.arange(Nx * Ny)
        for nx in range(Nx):
            for ny in range(Ny):
                ii = ny * Nc * Nx + nx * Nc + np.arange(Nc)
                jj = (Nx - nx - 1) * Nc * Ny + ny * Nc + np.arange(Nc)
                order_full[ii] = jj
                order_i[(Nx - nx - 1) * Ny + ny] = ny * Nx + nx
        self.Nx, self.Ny = Ny, Nx
        Jp = self.J[order_full, :][:, order_full]
        self.J = (scipy.sparse.triu(Jp) + scipy.sparse.tril(Jp, -1).T).tocsr()
        self._build()
        return order_i

    def add_noise(self, amplitude=1e-7, rng=None):
        """Uniform noise in [-amplitude, amplitude) on the nonzero couplings
        (reference `tnac4o/tnac4o.py:928-933`).

        With ``rng=None`` the *global* legacy NumPy RNG is used, as the
        reference's ``np.random.rand``, so ``np.random.seed(s);
        solver.add_noise(...)`` gives the same couplings as tnax."""
        J = self.J.tolil()
        rows, cols = J.nonzero()
        u = np.random.rand(len(rows)) if rng is None \
            else rng.random(len(rows))
        noise = (u * 2 - 1) * amplitude
        for i, j, k in zip(rows, cols, noise):
            J[i, j] += k
        self.J = J.tocsr()
        self._build()

    # -- decode -------------------------------------------------------------
    def decode_states(self, states: np.ndarray, ind0, L: int) -> np.ndarray:
        """Block-state integers -> per-spin bits (1=up, 0=down, 2=inactive).

        ``ind0``: active-spin ids of the *unrotated* lattice; ``states`` are in
        unrotated cluster order (reference `binary_states`,
        `tnac4o/tnac4o.py:261-286`).
        """
        ns = states.shape[0]
        out = np.full((ns, L), 2, dtype=np.int8)
        kk = -1
        for ny in range(len(ind0)):
            for nx in range(len(ind0[0])):
                kk += 1
                act = ind0[ny][nx]
                if len(act) == 0:
                    continue
                conf = 1 - block_bits(len(act))  # 1=up when bit==0
                out[:, act] = conf[states[:ns, kk]]
        return out


class RMFProblem(Problem):
    """Random Markov Field on an Ny x Nx rectangular lattice.

    ``J = {'fun': {...}, 'fac': {...}, 'N': array, 'Nx': int, 'Ny': int}``
    (reference `tnac4o/tnac4o.py:109-115`).
    """

    mode = "RMF"

    def __init__(self, Nx: int, Ny: int, J: dict):
        self.Nx = Nx
        self.Ny = Ny
        self.J = {"fun": dict(J["fun"]), "fac": dict(J["fac"]),
                  "N": np.array(J["N"]), "Nx": Nx, "Ny": Ny}
        self._build()

    @property
    def N(self):
        return self._N

    def _build(self):
        Ny, Nx = self.Ny, self.Nx
        self._N = np.array(self.J["N"], dtype=int)
        fac = self.J["fac"]
        self.ll = np.ones((Ny, Nx), dtype=int)
        self.lr = np.ones((Ny, Nx), dtype=int)
        self.lu = np.ones((Ny, Nx), dtype=int)
        self.ld = np.ones((Ny, Nx), dtype=int)
        for ny in range(Ny):
            for nx in range(Nx):
                if ((ny, nx - 1, ny, nx) in fac) or \
                        ((ny, nx, ny, nx - 1) in fac):
                    self.ll[ny, nx] = self._N[ny, nx - 1]
                if ((ny, nx, ny, nx + 1) in fac) or \
                        ((ny, nx + 1, ny, nx) in fac):
                    self.lr[ny, nx] = self._N[ny, nx + 1]
                if ((ny - 1, nx, ny, nx) in fac) or \
                        ((ny, nx, ny - 1, nx) in fac):
                    self.lu[ny, nx] = self._N[ny - 1, nx]
                if ((ny, nx, ny + 1, nx) in fac) or \
                        ((ny + 1, nx, ny, nx) in fac):
                    self.ld[ny, nx] = self._N[ny + 1, nx]
        self._site_cache = {}
        # the padded grid and energy rows (engine.pad_grid,
        # search.padded_energy_rows) are cached on the problem
        self._grid_cache = None
        self._energy_rows_np = None

    def _pair_table(self, keyA, keyB, shape):
        """E(s_here, s_neighbour) with the reference's lookup order
        (`tnac4o/tnac4o.py:1620-1635`)."""
        fac, fun = self.J["fac"], self.J["fun"]
        if keyA in fac:
            return np.asarray(fun[fac[keyA]], dtype=float).T
        if keyB in fac:
            return np.asarray(fun[fac[keyB]], dtype=float)
        return np.zeros(shape)

    def site(self, ny: int, nx: int) -> SiteTables:
        key = (ny, nx)
        if key in self._site_cache:
            return self._site_cache[key]
        n = self._N[ny, nx]
        fac, fun = self.J["fac"], self.J["fun"]
        Es = np.asarray(fun[fac[(ny, nx)]], dtype=float).reshape(n) \
            if (ny, nx) in fac else np.zeros(n)
        nl, nd = self.ll[ny, nx], self.ld[ny, nx]
        nr, nu = self.lr[ny, nx], self.lu[ny, nx]
        Esl = self._pair_table((ny, nx - 1, ny, nx), (ny, nx, ny, nx - 1),
                               (n, nl))
        Esu = self._pair_table((ny - 1, nx, ny, nx), (ny, nx, ny - 1, nx),
                               (n, nu))
        s = np.arange(n, dtype=np.int64)
        tab = SiteTables(n=n, Es=Es, Esl=Esl, Esu=Esu,
                         dmap=s % nd, rmap=s % nr,
                         nl=nl, nd=nd, nr=nr, nu=nu)
        self._site_cache[key] = tab
        return tab

    def rotate(self):
        """Rotate 90 degrees (reference `tnac4o/tnac4o.py:315-336`).

        The reference uses the *opposite* ``order_i`` convention in RMF
        mode (``order_i[ii] = jj``, reference `tnac4o/tnac4o.py:330-332`)
        to Ising mode's (``order_i[jj] = ii``, `:310`); kept as it is, as
        tnax keeps it.
        """
        Nx, Ny = self.Nx, self.Ny
        fac_new = {}
        order_i = np.arange(Nx * Ny)
        N_new = np.zeros((Nx, Ny), dtype=int)
        for key, val in self.J["fac"].items():
            if len(key) == 2:
                ny, nx = key
                fac_new[(Nx - nx - 1, ny)] = val
            else:
                ny1, nx1, ny2, nx2 = key
                fac_new[(Nx - nx1 - 1, ny1, Nx - nx2 - 1, ny2)] = val
        for nx in range(Nx):
            for ny in range(Ny):
                N_new[Nx - nx - 1, ny] = self._N[ny, nx]
                order_i[ny * Nx + nx] = (Nx - nx - 1) * Ny + ny
        self.Nx, self.Ny = Ny, Nx
        self.J["fac"] = fac_new
        self.J["N"] = N_new
        self._build()
        return order_i

    def add_noise(self, amplitude=1e-7, rng=None):
        """Noise on 1-site factors (reference `tnac4o/tnac4o.py:935-941`).
        ``rng=None`` uses the global legacy RNG, as the reference's
        ``np.random.rand``, so ``np.random.seed(s)`` gives tnax's
        factors."""
        fun_new = {}
        for key, val in self.J["fun"].items():
            fun_new[key] = np.array(val, dtype=float)
            if fun_new[key].ndim == 1:
                n = fun_new[key].shape[0]
                u = np.random.rand(n) if rng is None else rng.random(n)
                fun_new[key] = fun_new[key] + (u * 2 - 1) * amplitude
        self.J["fun"] = fun_new
        self._site_cache = {}
        self._grid_cache = None
        self._energy_rows_np = None

    def decode_states(self, states, ind0, L):
        return states
