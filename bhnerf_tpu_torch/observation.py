"""EHT instrument model: uv synthesis, noise, and measurement operators.

The port's copy of `bhnerf_tpu/observation.py` (numpy only, so it is
carried whole and gives bitwise the same arrays for the same seed; its
one package import, `units`, is the port's). It replaces the
`eht-imaging` dependency surface the reference consumes (SURVEY.md
§2.3): observation synthesis (reference bhnerf/observation.py:79-187
wraps ehtim.array.obsdata + movie.observe_same) and chi-square data
extraction (reference bhnerf/optimization.py:234-251 wraps
ehtim.imaging.imager_utils.chisqdata_<dtype>, whose dense DTFT matrix A is
used as a pure matmul at network.py:542-544).

Everything here is plain numpy on host (once per experiment) producing
dense arrays; the training-time operator is the batched matmul
A @ vec(image), split into real and imaginary parts
(train.step.to_real_measurements).

Physics implemented:
* ECEF station coordinates -> (u, v, w) projections toward (ra, dec)
  through Greenwich sidereal rotation;
* elevation-limit flagging per station;
* thermal noise sigma = sqrt(SEFD_i SEFD_j / (2 bw tint)) / 0.88 (the
  standard EHT quantization-corrected radiometer equation);
* station gain/phase corruption with the EHT2017-calibrated gain tables
  of the reference (observation.py:152-155): a constant per-station
  amplitude offset plus scan-stabilized wander correlated across scans
  with a Gauss-Markov process of correlation time `sigmat` hours
  (reference observation.py:160-161 stabilize_scan_* + sigmat);
* Jones-matrix polarimetric corruption in the circular (R/L) basis with
  per-station complex D-term leakage (reference dterm_noise path,
  observation.py:164-168: dcal=False, dterm_offset=0.05, frcal=True so
  no field-rotation term);
* amplitude debiasing sqrt(max(|V|^2 - sigma^2, 0)) in chisqdata('amp')
  (ehtim chisqdata_amp debias=True default);
* minimal closure-phase triangle sets per scan.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

# EHT2017-approximated gain statistics (reference observation.py:150-155)
GAIN_OFFSET = {'ALMA': 0.15, 'APEX': 0.15, 'SMT': 0.15, 'LMT': 0.6,
               'PV': 0.15, 'SMA': 0.15, 'JCMT': 0.15, 'SPT': 0.15,
               'SR': 0.0}
GAINP = {'ALMA': 0.05, 'APEX': 0.05, 'SMT': 0.05, 'LMT': 0.5, 'PV': 0.05,
         'SMA': 0.05, 'JCMT': 0.05, 'SPT': 0.15, 'SR': 0.0}

C_LIGHT = 2.99792458e8
SGRA_RA = 17.761121055553343     # fractional hours
SGRA_DEC = -29.00784305556       # degrees
SGRA_RF = 226191789062.5         # Hz


@dataclasses.dataclass
class ArrayConfig:
    """Station table: names, ECEF positions [m], SEFDs [Jy], and the
    optional polarimetric columns of the ehtim format (field-rotation
    coefficients + fixed D-terms)."""

    names: list
    xyz: np.ndarray    # (nstations, 3)
    sefd: np.ndarray   # (nstations,)
    # field-rotation model phi_fr = fr_par * parallactic + fr_elev *
    # elevation + fr_off (ehtim FR_PAR/FR_ELEV/FR_OFFSET[deg] columns)
    fr_par: np.ndarray = None
    fr_elev: np.ndarray = None
    fr_off: np.ndarray = None      # radians (table column is degrees)
    # fixed station D-terms from the table (DR/DL columns)
    d_R: np.ndarray = None
    d_L: np.ndarray = None

    def __post_init__(self):
        ns = len(self.names)
        z = lambda v: np.zeros(ns) if v is None else np.asarray(v)
        self.fr_par = z(self.fr_par)
        self.fr_elev = z(self.fr_elev)
        self.fr_off = z(self.fr_off)
        self.d_R = (np.zeros(ns, complex) if self.d_R is None
                    else np.asarray(self.d_R, complex))
        self.d_L = (np.zeros(ns, complex) if self.d_L is None
                    else np.asarray(self.d_L, complex))

    @classmethod
    def load_txt(cls, path):
        """Parse an ehtim-format station table (eht_arrays/*.txt):
        NAME X Y Z SEFDR [SEFDL FR_PAR FR_ELEV FR_OFF[deg]
        DR_RE DR_IM DL_RE DL_IM]."""
        names, xyz, sefd = [], [], []
        fr_par, fr_elev, fr_off, d_R, d_L = [], [], [], [], []
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            p = line.split()
            names.append(p[0])
            xyz.append([float(p[1]), float(p[2]), float(p[3])])
            sefd.append(float(p[4]))
            get = lambda i, d=0.0: float(p[i]) if len(p) > i else d
            fr_par.append(get(6))
            fr_elev.append(get(7))
            fr_off.append(np.deg2rad(get(8)))
            d_R.append(get(9) + 1j * get(10))
            d_L.append(get(11) + 1j * get(12))
        return cls(names, np.asarray(xyz), np.asarray(sefd),
                   fr_par=np.asarray(fr_par), fr_elev=np.asarray(fr_elev),
                   fr_off=np.asarray(fr_off), d_R=np.asarray(d_R),
                   d_L=np.asarray(d_L))

    @property
    def nstations(self):
        return len(self.names)


def load_txt(path):
    """ehtim.array.load_txt parity."""
    return ArrayConfig.load_txt(path)


def gmst_hours(mjd, ut_hours):
    """Greenwich mean sidereal time (hours) from MJD + UT hours.

    Standard USNO approximation; arcsecond-level accuracy, ample for uv
    coverage synthesis.
    """
    jd0 = np.floor(mjd) + 2400000.5
    d0 = jd0 - 2451545.0
    t = d0 / 36525.0
    gmst0 = 6.697374558 + 0.06570982441908 * d0 + 0.000026 * t**2
    return (gmst0 + 1.00273790935 * ut_hours) % 24.0


@dataclasses.dataclass
class Observation:
    """Dense interferometric observation container (ehtim.Obsdata analog).

    Scan-major layout: arrays are (nscan, nbl) with NaN/masked entries for
    flagged baselines. vis is (nscan, nbl, nstokes) complex or None for an
    'empty' observation (uv coverage only).
    """

    array: ArrayConfig
    times: np.ndarray         # (nscan,) UT hours
    baselines: np.ndarray     # (nbl, 2) station indices, i < j
    u: np.ndarray             # (nscan, nbl) in wavelengths
    v: np.ndarray             # (nscan, nbl)
    mask: np.ndarray          # (nscan, nbl) True = valid
    sigma: np.ndarray         # (nscan, nbl) thermal noise [Jy]
    ra: float = SGRA_RA
    dec: float = SGRA_DEC
    rf: float = SGRA_RF
    mjd: int = 57850
    bw: float = 1856000000.0
    tint: float = 60.0
    vis: np.ndarray = None    # (nscan, nbl, nstokes) complex
    pol_names: tuple = ('I', 'Q', 'U', 'V')
    # ground-truth corruption actually applied by observe_same (the
    # ehtim caltable analog — reference observation.py:121,133 writes a
    # caltable so experiments can self-calibrate against known gains);
    # None when the observation carries no station corruption
    applied_jones: 'AppliedJones' = None

    # ---- ehtim-parity accessors -----------------------------------------
    @property
    def nscan(self):
        return len(self.times)

    @property
    def nbl(self):
        return len(self.baselines)

    def tlist(self):
        """Per-scan record list (ehtim obs.tlist() analog)."""
        out = []
        for s in range(self.nscan):
            valid = self.mask[s]
            rec = {
                'time': np.full(valid.sum(), self.times[s]),
                'u': self.u[s, valid], 'v': self.v[s, valid],
                'sigma': self.sigma[s, valid],
                't1': self.baselines[valid, 0],
                't2': self.baselines[valid, 1],
            }
            if self.vis is not None:
                for p, name in enumerate(self.pol_names):
                    if p < self.vis.shape[-1]:
                        rec[{'I': 'vis', 'Q': 'qvis', 'U': 'uvis',
                             'V': 'vvis'}[name]] = self.vis[s, valid, p]
            out.append(rec)
        return out

    def scan_frame_assignment(self, t_frames_hr):
        """Assign each scan to the nearest frame time (the reference
        gathers scans into len(t_frames) groups — optimization.py:241)."""
        t_frames_hr = np.asarray(t_frames_hr, np.float64)
        return np.argmin(np.abs(self.times[:, None]
                                - t_frames_hr[None, :]), axis=1)

    @classmethod
    def from_uvdata(cls, time, t1, t2, u, v, sigma, vis=None, qvis=None,
                    uvis=None, vvis=None, ra=SGRA_RA, dec=SGRA_DEC,
                    rf=SGRA_RF, mjd=57850, bw=1856000000.0, tint=60.0):
        """Build an Observation from flat per-visibility records.

        Migration path for reference users holding real `ehtim.Obsdata`
        objects (the reference's TrainStep.eht consumes them directly —
        optimization.py:219-268; ehtim is not a dependency here): pass
        the columns of ``obs.data`` verbatim, e.g. ::

            Observation.from_uvdata(
                time=obs.data['time'], t1=obs.data['t1'],
                t2=obs.data['t2'], u=obs.data['u'], v=obs.data['v'],
                sigma=obs.data['sigma'], vis=obs.data['vis'],
                qvis=obs.data['qvis'], uvis=obs.data['uvis'],
                ra=obs.ra, dec=obs.dec, rf=obs.rf, mjd=obs.mjd)

        t1/t2 may be station-name strings or integer indices. Station
        positions/SEFDs are not recoverable from uv records; the
        embedded ArrayConfig is a name-only stub, which every
        measurement-operator path (chisqdata vis/amp/cphase, closure
        triangles, padded_obs) works from — only fresh `observe_same`
        synthesis needs a real station table.
        """
        time = np.asarray(time, np.float64)
        t1 = np.asarray(t1)
        t2 = np.asarray(t2)
        names = sorted({str(s) for s in t1} | {str(s) for s in t2})
        s_idx = {n: i for i, n in enumerate(names)}
        i1 = np.array([s_idx[str(s)] for s in t1])
        i2 = np.array([s_idx[str(s)] for s in t2])
        lo, hi = np.minimum(i1, i2), np.maximum(i1, i2)
        # canonicalizing a record to (lo, hi) station order flips its
        # baseline: V(j,i) = conj(V(i,j)) at (-u, -v). Without this,
        # closure triangles built from mixed-orientation input no longer
        # close and cphase targets are silently corrupted.
        flip = i1 > i2
        sign = np.where(flip, -1.0, 1.0)
        u = np.asarray(u, np.float64) * sign
        v = np.asarray(v, np.float64) * sign

        def orient(p):
            p = np.asarray(p, complex)
            return np.where(flip, np.conj(p), p)

        times = np.unique(time)
        pairs = sorted({(int(a), int(b)) for a, b in zip(lo, hi)})
        baselines = np.asarray(pairs, int)
        b_idx = {p: i for i, p in enumerate(pairs)}
        scan_of = np.searchsorted(times, time)
        bl_of = np.array([b_idx[(int(a), int(b))]
                          for a, b in zip(lo, hi)])

        # duplicate (scan, baseline) records (e.g. multi-channel / multi-IF
        # ehtim data not yet frequency-averaged) would silently overwrite
        # each other below (last row wins) — refuse instead
        pair_keys = scan_of * len(baselines) + bl_of
        if len(np.unique(pair_keys)) != len(pair_keys):
            dup = np.flatnonzero(np.bincount(pair_keys) > 1)[0]
            s_i, b_i = divmod(int(dup), len(baselines))
            raise ValueError(
                f'duplicate records for time={times[s_i]} baseline='
                f'{names[baselines[b_i][0]]}-{names[baselines[b_i][1]]}; '
                f'average over IFs/channels before from_uvdata')

        nscan, nbl = len(times), len(baselines)
        U = np.zeros((nscan, nbl))
        V = np.zeros((nscan, nbl))
        SG = np.full((nscan, nbl), np.inf)
        M = np.zeros((nscan, nbl), bool)
        U[scan_of, bl_of] = np.asarray(u, np.float64)
        V[scan_of, bl_of] = np.asarray(v, np.float64)
        SG[scan_of, bl_of] = np.asarray(sigma, np.float64)
        M[scan_of, bl_of] = True

        provided = [(name, p) for name, p in
                    zip('IQUV', (vis, qvis, uvis, vvis)) if p is not None]
        VIS, pol_names = None, ('I', 'Q', 'U', 'V')
        if provided:
            # pol_names tracks exactly the provided components, so a
            # non-contiguous set (e.g. I+V) keeps its identity
            pol_names = tuple(name for name, _ in provided)
            VIS = np.zeros((nscan, nbl, len(provided)), complex)
            for k, (_, p) in enumerate(provided):
                VIS[scan_of, bl_of, k] = orient(p)
        array = ArrayConfig(names, np.zeros((len(names), 3)),
                            np.zeros(len(names)))
        return cls(array=array, times=times, baselines=baselines, u=U,
                   v=V, mask=M, sigma=SG, ra=ra, dec=dec, rf=rf,
                   mjd=int(mjd), bw=bw, tint=tint, vis=VIS,
                   pol_names=pol_names)

    def calibrate(self, jones=None, gains=True, dterms=True,
                  field_rotation=True):
        """Undo KNOWN station corruption (self-cal with truth tables).

        jones defaults to the `applied_jones` recorded by observe_same
        — the corrupt -> calibrate round trip then recovers the
        uncorrupted visibilities to machine precision (minus thermal
        noise, which no calibration removes). Pass gains/dterms/
        field_rotation=False to leave that term in (e.g. calibrate
        known D-terms + feed angles while fitting gain errors — the
        ehtim inv_jones workflow, reference observation.py:183-185).
        """
        jones = self.applied_jones if jones is None else jones
        if jones is None:
            raise ValueError('no applied_jones recorded on this '
                             'observation and none passed')
        if self.vis is None:
            raise ValueError('observation carries no visibilities')
        vis = apply_inverse_jones(
            self.vis, self.baselines,
            g_R=jones.g_R if gains else None,
            g_L=jones.g_L if gains else None,
            d_R=jones.d_R if dterms else None,
            d_L=jones.d_L if dterms else None,
            phi=jones.phi if field_rotation else None)
        vis[~self.mask] = np.nan
        # the calibrated observation records only the terms STILL in the
        # data (None when fully calibrated) — a repeated calibrate()
        # must not silently invert the Jones chain twice
        remaining = AppliedJones(
            g_R=None if gains else jones.g_R,
            g_L=None if gains else jones.g_L,
            d_R=None if dterms else jones.d_R,
            d_L=None if dterms else jones.d_L,
            phi=None if field_rotation else jones.phi)
        if all(getattr(remaining, f) is None
               for f in ('g_R', 'd_R', 'phi')):
            remaining = None
        return dataclasses.replace(self, vis=vis,
                                   applied_jones=remaining)

    # ---- measurement operators -------------------------------------------
    def chisqdata(self, t_frames, dtype, image_fov, image_size, pol='I',
                  debias=True, operator='dense'):
        """(target, sigma, A) stacked per frame
        (ehtim chisqdata_<dtype> + reference optimization.py:241-255).

        image_fov: radians. Returns (operator='dense'):
          'vis'/'amp': target (nt,[pol,]nvis), sigma same, A
              (nt,[pol,]nvis,npix^2) complex
          'cphase': target (nt, ntri), sigma (nt, ntri) [radians], A
              (nt, 3, ntri, npix^2)
          'bs': target (nt, ntri) complex bispectra, sigma (nt, ntri),
              A as for 'cphase'
          'logcamp'/'camp': target (nt, nquad), sigma (nt, nquad), A
              (nt, 4, nquad, npix^2) — legs numerator (0, 1) then
              denominator (2, 3); see _scan_quadrangles
        For 'amp', amplitudes are debiased by default:
        sqrt(max(|V|^2 - sigma^2, 0)) (ehtim chisqdata_amp debias=True),
        removing the low-SNR Rice-distribution bias of |V|.

        operator='factored' replaces every dense-DFT axis (..., npix^2)
        with a real separable stack (..., 4, n_meas, npix) built by
        dft_factors — npix-fold smaller, the production-npix form (the
        reference gets this from ehtim's NFFT backend,
        observation.py:121). Targets/sigmas are identical; the loss
        consumes either form transparently.
        """
        from bhnerf_tpu_torch import units as units_lib
        if operator not in ('dense', 'factored'):
            raise ValueError(f'operator must be dense|factored, '
                             f'got {operator!r}')
        factored = operator == 'factored'
        if hasattr(t_frames, 'value'):
            t_frames = units_lib.Quantity(t_frames, 'hr').value
        t_frames = np.asarray(t_frames, np.float64)
        nt = len(t_frames)
        assign = self.scan_frame_assignment(t_frames)

        pols = [pol] if isinstance(pol, str) else list(pol)
        pol_idx = [list(self.pol_names).index(p) for p in pols]

        if dtype in ('vis', 'amp'):
            per_frame = []
            for f in range(nt):
                scans = np.nonzero(assign == f)[0]
                uu = [np.zeros(0)]
                vv = [np.zeros(0)]
                sg = [np.zeros(0)]
                tg = [np.zeros((0, len(pols)), complex)]
                for s in scans:
                    val = self.mask[s]
                    uu.append(self.u[s, val])
                    vv.append(self.v[s, val])
                    sg.append(self.sigma[s, val])
                    tg.append(self.vis[s, val][:, pol_idx])
                per_frame.append((np.concatenate(uu), np.concatenate(vv),
                                  np.concatenate(tg), np.concatenate(sg)))
            nvis = max(len(p[0]) for p in per_frame)
            target = np.zeros((nt, len(pols), nvis), complex)
            sigma = np.full((nt, len(pols), nvis), np.inf)
            if factored:
                A = np.zeros((nt, len(pols), 4, nvis, image_size))
            else:
                A = np.zeros((nt, len(pols), nvis, image_size**2),
                             complex)
            for f, (uu, vv, tg, sg) in enumerate(per_frame):
                n = len(uu)
                if factored:
                    ft = dft_factors(uu, vv, image_fov, image_size)
                else:
                    ft = dft_matrix(uu, vv, image_fov, image_size)
                for k in range(len(pols)):
                    target[f, k, :n] = tg[:, k]
                    sigma[f, k, :n] = sg
                    if factored:
                        A[f, k, :, :n] = ft
                    else:
                        A[f, k, :n] = ft
            if dtype == 'amp':
                target = np.abs(target)
                if debias:
                    target = amp_debias(target, sigma)
            if len(pols) == 1:
                # drop only the pol axis — never nt/nvis (nt=1 or nvis=1
                # must keep the documented (nt, ..., nvis) contract)
                target, sigma, A = target[:, 0], sigma[:, 0], A[:, 0]
            return target, sigma, A

        if dtype in ('cphase', 'bs'):
            if len(pols) != 1:
                raise ValueError(f'{dtype} supports a single pol')
            p = pol_idx[0]
            per_frame = []
            for f in range(nt):
                scans = np.nonzero(assign == f)[0]
                rows = []
                for s in scans:
                    rows.extend(self._scan_triangles(s, p))
                per_frame.append(rows)
            # pad to >=1 row (sigma=inf, A=0 rows are loss-inert) so a
            # frame split with no closable triangle still yields valid
            # (nt, ntri) shapes — same guard as the logcamp branch below
            ntri = max(max(len(r) for r in per_frame), 1)
            target = np.zeros((nt, ntri),
                              complex if dtype == 'bs' else float)
            sigma = np.full((nt, ntri), np.inf)
            if factored:
                A = np.zeros((nt, 3, 4, ntri, image_size))
            else:
                A = np.zeros((nt, 3, ntri, image_size**2), complex)
            for f, rows in enumerate(per_frame):
                for k, (uvs, bisp, cp, cp_sigma) in enumerate(rows):
                    if dtype == 'bs':
                        target[f, k] = bisp
                        # sigma_|B| = |B| sqrt(sum (sigma_i/|V_i|)^2)
                        # (ehtim chisqdata_bs error propagation)
                        sigma[f, k] = np.abs(bisp) * cp_sigma
                    else:
                        target[f, k] = cp
                        sigma[f, k] = cp_sigma
                    for leg in range(3):
                        if factored:
                            A[f, leg, :, k] = dft_factors(
                                uvs[leg][0:1], uvs[leg][1:2], image_fov,
                                image_size)[:, 0]
                        else:
                            A[f, leg, k] = dft_matrix(
                                uvs[leg][0:1], uvs[leg][1:2], image_fov,
                                image_size)[0]
            return target, sigma, A

        if dtype in ('logcamp', 'camp'):
            if len(pols) != 1:
                raise ValueError(f'{dtype} supports a single pol')
            p = pol_idx[0]
            per_frame = []
            for f in range(nt):
                scans = np.nonzero(assign == f)[0]
                rows = []
                for s in scans:
                    rows.extend(self._scan_quadrangles(s, p,
                                                       debias=debias))
                per_frame.append(rows)
            nq = max(len(r) for r in per_frame) if per_frame else 0
            nq = max(nq, 1)
            target = np.zeros((nt, nq))
            sigma = np.full((nt, nq), np.inf)
            if factored:
                A = np.zeros((nt, 4, 4, nq, image_size))
            else:
                A = np.zeros((nt, 4, nq, image_size**2), complex)
            for f, rows in enumerate(per_frame):
                for k, (uvs, lca, lca_sigma) in enumerate(rows):
                    target[f, k] = lca
                    sigma[f, k] = lca_sigma
                    for leg in range(4):
                        if factored:
                            A[f, leg, :, k] = dft_factors(
                                uvs[leg][0:1], uvs[leg][1:2], image_fov,
                                image_size)[:, 0]
                        else:
                            A[f, leg, k] = dft_matrix(
                                uvs[leg][0:1], uvs[leg][1:2], image_fov,
                                image_size)[0]
            if dtype == 'camp':
                camp = np.exp(target)
                sigma = np.where(np.isfinite(sigma), camp * sigma, np.inf)
                target = camp
            return target, sigma, A

        raise ValueError(f'dtype {dtype} not supported')

    def _scan_quadrangles(self, s, pol_index, debias=True):
        """Maximal independent set of log closure amplitudes for scan s.

        Counterpart of ehtim's chisqdata_logcamp operator build
        (reference consumes it via the chisqdata hook,
        optimization.py:234-251). Each closure amplitude on stations
        (i, j, k, l) is |V_ij||V_kl| / (|V_ik||V_jl|); station gain
        amplitudes cancel because every station appears once upstairs
        and once downstairs. Rather than hardcode one enumeration
        convention, candidates (all 3 pairings of every 4-station
        subset) are greedily accepted when their baseline-incidence
        vector is linearly independent of the accepted set — an exact
        maximal independent family (n(n-3)/2 rows for a fully-connected
        n-station scan) by construction.

        Returns rows (uvs[4], logcamp, sigma_logcamp); legs ordered
        numerator (0, 1) then denominator (2, 3).
        """
        from itertools import combinations
        valid = np.nonzero(self.mask[s])[0]
        bl = {tuple(self.baselines[b]): b for b in valid}
        stations = sorted({st for b in valid for st in self.baselines[b]})
        if len(stations) < 4:
            return []
        bl_index = {pair: n for n, pair in enumerate(sorted(bl))}

        def leg(i, j):
            """(amp_debiased, sigma, u, v, basis_index) or None."""
            pair = (min(i, j), max(i, j))
            if pair not in bl:
                return None
            b = bl[pair]
            amp = np.abs(self.vis[s, b, pol_index])
            sg = self.sigma[s, b]
            if debias:
                amp = float(amp_debias(amp, sg))
            if not amp > 0.0:
                return None     # SNR too low to form a log amplitude
            return amp, sg, self.u[s, b], self.v[s, b], bl_index[pair]

        rows = []
        basis = np.zeros((0, len(bl_index)))
        for quad in combinations(stations, 4):
            a, b, c, d = quad
            for (n1, n2, d1, d2) in (((a, b), (c, d), (a, c), (b, d)),
                                     ((a, c), (b, d), (a, d), (b, c)),
                                     ((a, d), (b, c), (a, b), (c, d))):
                legs = [leg(*n1), leg(*n2), leg(*d1), leg(*d2)]
                if any(l is None for l in legs):
                    continue
                vec = np.zeros(len(bl_index))
                for l, sign in zip(legs, (1.0, 1.0, -1.0, -1.0)):
                    vec[l[4]] += sign
                resid = vec - basis.T @ (basis @ vec)
                norm = np.linalg.norm(resid)
                if norm < 1e-9:
                    continue    # dependent on already-accepted closures
                basis = np.vstack([basis, resid / norm])
                lca = (np.log(legs[0][0]) + np.log(legs[1][0])
                       - np.log(legs[2][0]) - np.log(legs[3][0]))
                lca_sigma = float(np.sqrt(sum(
                    (l[1] / l[0]) ** 2 for l in legs)))
                uvs = [(l[2], l[3]) for l in legs]
                rows.append((uvs, float(lca), lca_sigma))
        return rows

    def _scan_triangles(self, s, pol_index):
        """Minimal independent closure-phase set for scan s: all triangles
        containing the pivot (first valid) station."""
        valid = np.nonzero(self.mask[s])[0]
        bl = {tuple(self.baselines[b]): b for b in valid}
        stations = sorted({st for b in valid for st in self.baselines[b]})
        if len(stations) < 3:
            return []
        piv = stations[0]
        rows = []

        def get(i, j):
            """visibility + uv for baseline (i,j), conjugated if j < i."""
            if (min(i, j), max(i, j)) not in bl:
                return None
            b = bl[(min(i, j), max(i, j))]
            vis = self.vis[s, b, pol_index]
            uu, vv, sg = self.u[s, b], self.v[s, b], self.sigma[s, b]
            if j < i:
                vis, uu, vv = np.conj(vis), -uu, -vv
            return vis, uu, vv, sg

        others = [st for st in stations if st != piv]
        for a in range(len(others)):
            for c in range(a + 1, len(others)):
                i, j = others[a], others[c]
                l1, l2, l3 = get(piv, i), get(i, j), get(j, piv)
                if l1 is None or l2 is None or l3 is None:
                    continue
                bisp = l1[0] * l2[0] * l3[0]
                cp = np.angle(bisp)
                # standard closure-phase error propagation
                amps = np.array([np.abs(l1[0]), np.abs(l2[0]),
                                 np.abs(l3[0])])
                sigs = np.array([l1[3], l2[3], l3[3]])
                cp_sigma = np.sqrt(np.sum((sigs / np.maximum(
                    amps, 1e-12)) ** 2))
                uvs = [(l1[1], l1[2]), (l2[1], l2[2]), (l3[1], l3[2])]
                rows.append((uvs, bisp, cp, cp_sigma))
        return rows


def amp_debias(amp, sigma):
    """Debiased visibility amplitude sqrt(max(|V|^2 - sigma^2, 0))
    (ehtim amp_debias; used by chisqdata_amp with debias=True).

    |V| of a complex-Gaussian-corrupted visibility is Rice-distributed
    with E[|V|^2] = |V0|^2 + sigma^2; subtracting sigma^2 in quadrature
    removes the leading-order bias at low SNR. inf/NaN sigmas (padding)
    pass through as zero-amplitude."""
    amp = np.asarray(amp, np.float64)
    s2 = np.where(np.isfinite(sigma), np.asarray(sigma, np.float64),
                  np.inf) ** 2
    return np.sqrt(np.clip(amp**2 - s2, 0.0, None))


def dft_matrix(u, v, image_fov, image_size, image_fov_y=None,
               image_size_y=None):
    """Dense DTFT matrix A (nvis, ny*nx): A @ vec(image) = visibilities.

    Pixel grid matches ehtim's make_square convention: coordinates in
    radians, centered, x increasing toward east (negative RA direction).
    The y axis defaults to the x configuration (square image); pass
    image_fov_y/image_size_y for rectangular movies.
    """
    def centered(fov, npix):
        pdim = fov / npix
        k = np.arange(npix)
        # ehtim ftmatrix pixel coordinates
        return pdim * (k - npix // 2 + 0.5 * ((npix + 1) % 2))

    x = -centered(image_fov, image_size)   # RA increases eastward (left)
    y = -centered(image_fov if image_fov_y is None else image_fov_y,
                  image_size if image_size_y is None else image_size_y)
    X, Y = np.meshgrid(x, y, indexing='xy')
    xv, yv = X.ravel(), Y.ravel()
    return np.exp(-2j * np.pi * (np.outer(u, xv) + np.outer(v, yv)))


def dft_factors(u, v, image_fov, image_size, image_fov_y=None,
                image_size_y=None):
    """Separable (factored) DTFT operator: real (4, nvis, npix) stack
    [Cu, Su, Cv, Sv] with

        dft_matrix(u, v)[k, r*nx + c]
            = (Cu - i Su)[k, c] * (Cv - i Sv)[k, r]

    i.e. the same type-3 DFT as `dft_matrix` factored over the image
    axes. Memory is npix-fold smaller than the dense matrix (the
    production-npix killer: a dense ngEHT operator at npix=128 is
    ~320 MB/frame-batch — reference observation.py:121 solves this with
    ehtim's NFFT backend; the factored form keeps the hot op a real
    (npix, npix) @ (npix, nvis) matmul). Applied in
    train.step.loss_fn_eht via two real matmuls + an elementwise
    combine; the complex product (Eu*Ev) matches the dense operator to
    f32 roundoff.

    Rectangular images pass image_fov_y/image_size_y; Cu/Su then carry
    npix_x columns and Cv/Sv npix_y, zero-padded to a common max so the
    four factors stack — train.step.apply_measurement_operator slices
    each factor back to the image's static nx/ny before contracting.
    """
    def centered(fov, npix):
        pdim = fov / npix
        k = np.arange(npix)
        return pdim * (k - npix // 2 + 0.5 * ((npix + 1) % 2))

    x = -centered(image_fov, image_size)
    y = -centered(image_fov if image_fov_y is None else image_fov_y,
                  image_size if image_size_y is None else image_size_y)
    pu = 2.0 * np.pi * np.outer(u, x)      # (nvis, npix_x)
    pv = 2.0 * np.pi * np.outer(v, y)      # (nvis, npix_y)
    npix = max(pu.shape[1], pv.shape[1])
    out = np.zeros((4, len(np.atleast_1d(u)), npix))
    out[0, :, :pu.shape[1]] = np.cos(pu)
    out[1, :, :pu.shape[1]] = np.sin(pu)
    out[2, :, :pv.shape[1]] = np.cos(pv)
    out[3, :, :pv.shape[1]] = np.sin(pv)
    return out


def empty_eht_obs(array, nt, tint, tstart=4.0, tstop=15.5, ra=SGRA_RA,
                  dec=SGRA_DEC, rf=SGRA_RF, mjd=57850, bw=1856000000.0,
                  elevmin=15.0, elevmax=85.0, timetype='UTC',
                  polrep='stokes'):
    """Synthesize uv coverage from a station array + scan cadence
    (reference observation.py:79-119)."""
    if timetype != 'UTC' or polrep != 'stokes':
        raise NotImplementedError(
            f'only UTC/stokes observations are supported '
            f'(got timetype={timetype!r}, polrep={polrep!r})')
    times = np.linspace(tstart, tstop, nt, endpoint=False)
    times = times + 0.5 * (tstop - tstart) / nt

    ns = array.nstations
    baselines = np.array([(i, j) for i in range(ns)
                          for j in range(i + 1, ns)])
    nbl = len(baselines)

    dec_r = np.deg2rad(dec)
    lam = C_LIGHT / rf

    u = np.zeros((nt, nbl))
    v = np.zeros((nt, nbl))
    mask = np.zeros((nt, nbl), bool)

    # station latitude/longitude for elevation cuts
    xyz = array.xyz
    lon = np.arctan2(xyz[:, 1], xyz[:, 0])
    lat = np.arctan2(xyz[:, 2], np.sqrt(xyz[:, 0]**2 + xyz[:, 1]**2))

    for s, t_ut in enumerate(times):
        gst = gmst_hours(mjd, t_ut) * 2 * np.pi / 24.0
        ha_greenwich = gst - ra * 2 * np.pi / 24.0  # hour angle at lon=0

        # elevation of source at each station
        ha_local = ha_greenwich + lon
        sin_el = (np.sin(lat) * np.sin(dec_r)
                  + np.cos(lat) * np.cos(dec_r) * np.cos(ha_local))
        el = np.rad2deg(np.arcsin(np.clip(sin_el, -1, 1)))
        station_ok = (el > elevmin) & (el < elevmax)

        ch, sh = np.cos(ha_greenwich), np.sin(ha_greenwich)
        sd, cd = np.sin(dec_r), np.cos(dec_r)
        B = xyz[baselines[:, 1]] - xyz[baselines[:, 0]]
        u[s] = (sh * B[:, 0] + ch * B[:, 1]) / lam
        v[s] = (-sd * ch * B[:, 0] + sd * sh * B[:, 1]
                + cd * B[:, 2]) / lam
        mask[s] = station_ok[baselines[:, 0]] & station_ok[baselines[:, 1]]

    sefd = array.sefd
    sigma = np.sqrt(sefd[baselines[:, 0]] * sefd[baselines[:, 1]]
                    / (2.0 * bw * tint)) / 0.88
    sigma = np.broadcast_to(sigma, (nt, nbl)).copy()

    return Observation(array=array, times=times, baselines=baselines, u=u,
                       v=v, mask=mask, sigma=sigma, ra=ra, dec=dec, rf=rf,
                       mjd=mjd, bw=bw, tint=tint)


def station_angles(obs):
    """Per-scan station elevation and parallactic angle (radians).

    Returns (elev, par), each (nscan, nstations). Standard spherical
    astronomy: local hour angle H = GMST - RA + longitude;
    sin(el) = sin(lat) sin(dec) + cos(lat) cos(dec) cos(H);
    tan(psi) = sin(H) / (tan(lat) cos(dec) - sin(dec) cos(H)).
    The reference gets these from ehtim's Jones machinery when
    frcal=False (observation.py:160-177 toggle surface).
    """
    xyz = obs.array.xyz
    lon = np.arctan2(xyz[:, 1], xyz[:, 0])
    lat = np.arctan2(xyz[:, 2], np.sqrt(xyz[:, 0]**2 + xyz[:, 1]**2))
    dec = np.deg2rad(obs.dec)
    gst = gmst_hours(obs.mjd, np.asarray(obs.times)) * 2 * np.pi / 24.0
    ha = (gst - obs.ra * 2 * np.pi / 24.0)[:, None] + lon[None, :]
    sin_el = (np.sin(lat) * np.sin(dec)
              + np.cos(lat) * np.cos(dec) * np.cos(ha))
    elev = np.arcsin(np.clip(sin_el, -1.0, 1.0))
    par = np.arctan2(np.sin(ha),
                     np.tan(lat) * np.cos(dec) - np.sin(dec) * np.cos(ha))
    return elev, par


def field_rotation_angles(obs):
    """Station feed rotation phi_fr = fr_par * parallactic + fr_elev *
    elevation + fr_off, (nscan, nstations) radians (the ehtim
    FR_PAR/FR_ELEV/FR_OFFSET station-table model applied when
    frcal=False)."""
    elev, par = station_angles(obs)
    arr = obs.array
    return (arr.fr_par[None, :] * par + arr.fr_elev[None, :] * elev
            + arr.fr_off[None, :])


def gauss_markov_series(rng, times_hr, n_series, sigmat):
    """Stationary unit-variance AR(1)/Ornstein-Uhlenbeck draws over scans.

    Correlation between scans at lag dt is exp(-dt / sigmat); sigmat <= 0
    degenerates to i.i.d. draws. Returns (nscan, n_series)."""
    times_hr = np.asarray(times_hr, np.float64)
    out = np.empty((len(times_hr), n_series))
    out[0] = rng.standard_normal(n_series)
    for s in range(1, len(times_hr)):
        rho = (np.exp(-abs(times_hr[s] - times_hr[s - 1]) / sigmat)
               if sigmat and sigmat > 0 else 0.0)
        out[s] = (rho * out[s - 1]
                  + np.sqrt(max(1.0 - rho**2, 0.0))
                  * rng.standard_normal(n_series))
    return out


@dataclasses.dataclass
class AppliedJones:
    """Ground-truth station corruption drawn by observe_same — the
    ehtim caltable analog (reference observation.py:121,133). Lets
    experiments close the self-calibration loop: corrupt, then
    `obs.calibrate()` (apply_inverse_jones with the KNOWN tables)
    recovers the uncorrupted visibilities exactly (thermal noise
    excepted, which is irreducible by calibration)."""

    g_R: np.ndarray            # (nscan, ns) complex feed gains
    g_L: np.ndarray            # (nscan, ns)
    d_R: np.ndarray            # (ns,) complex leakage
    d_L: np.ndarray            # (ns,)
    phi: np.ndarray = None     # (nscan, ns) field-rotation angles or None


def station_jones(obs, rng, station_noise=True, dterm_noise=False,
                  sigmat=0.25, dterm_offset=0.05, phase_std=2 * np.pi,
                  ampcal=None, phasecal=None, stabilize_scan_amp=True,
                  stabilize_scan_phase=True, rlgaincal=False,
                  neggains=False):
    """Per-scan, per-station Jones components (gains + D-terms).

    Models the reference's noise tier (observation.py:152-187):
    * constant per-station amplitude offset |1 + GAIN_OFFSET*N(0,1)|,
      shared between R and L feeds;
    * scan-stabilized gain wander of std GAINP and phase wander,
      independent per feed (rlgaincal=False), both Gauss-Markov across
      scans with correlation time `sigmat` hours (i.i.d. between distant
      scans, frozen within ~sigmat — the ehtim stabilize_scan_* +
      sigmat behavior). Phase wander has stationary std `phase_std`
      (default 2*pi: effectively uniform once decorrelated, matching
      uncalibrated station phases under adhoc phasing);
    * complex D-terms per feed, constant in time, std `dterm_offset`
      per real component (reference observation.py:166).

    ampcal / phasecal expose the ehtim toggle surface independently
    (reference observation.py:171-180): ampcal=True suppresses the
    amplitude errors, phasecal=True the phase errors; both default to
    `not station_noise`. stabilize_scan_amp/phase=False decorrelate the
    wander between scans (i.i.d. draws; the scan is the finest time
    granularity of this container, so "per-integration" variation means
    per-scan here). rlgaincal=True correlates the feeds (R and L share
    the SAME time-dependent gain draws; False — the reference's
    station-noise setting — draws them independently). neggains=True
    makes the constant per-station offsets one-sided signal LOSSES,
    |1| - off*|N(0,1)| <= 1, instead of symmetric (ehtim's neggains;
    reference passes False, observation.py:167,184).

    Returns (g_R, g_L, d_R, d_L): gains (nscan, ns) complex and D-terms
    (ns,) complex.
    """
    ns = obs.array.nstations
    ampcal = (not station_noise) if ampcal is None else ampcal
    phasecal = (not station_noise) if phasecal is None else phasecal
    g_R = np.ones((obs.nscan, ns), complex)
    g_L = np.ones((obs.nscan, ns), complex)
    if not (ampcal and phasecal):
        off = np.array([GAIN_OFFSET.get(n, 0.1) for n in obs.array.names])
        gp = np.array([GAINP.get(n, 0.05) for n in obs.array.names])
        if neggains:        # one-sided: stations only LOSE sensitivity
            const_gain = 1.0 - off * np.abs(rng.standard_normal(ns))
        else:
            const_gain = 1.0 + off * rng.standard_normal(ns)
        # rlgaincal=True: R/L feeds share one set of wander draws
        feeds = (g_R,) if rlgaincal else (g_R, g_L)
        for g in feeds:
            amp_w = gauss_markov_series(
                rng, obs.times, ns, sigmat if stabilize_scan_amp else 0.0)
            ph_w = gauss_markov_series(
                rng, obs.times, ns,
                sigmat if stabilize_scan_phase else 0.0)
            if not ampcal:
                g *= np.abs(const_gain * (1.0 + gp * amp_w))
            if not phasecal:
                g *= np.exp(1j * phase_std * ph_w)
        if rlgaincal:
            g_L[:] = g_R
    d_R = np.zeros(ns, complex)
    d_L = np.zeros(ns, complex)
    if dterm_noise:
        d_R = dterm_offset * (rng.standard_normal(ns)
                              + 1j * rng.standard_normal(ns))
        d_L = dterm_offset * (rng.standard_normal(ns)
                              + 1j * rng.standard_normal(ns))
    return g_R, g_L, d_R, d_L


def _stokes_to_circ(vis):
    nscan, nbl, nstokes = vis.shape
    z = np.zeros((nscan, nbl), complex)
    I = vis[..., 0]
    Q = vis[..., 1] if nstokes > 1 else z
    U = vis[..., 2] if nstokes > 2 else z
    V = vis[..., 3] if nstokes > 3 else z
    return I + V, Q + 1j * U, Q - 1j * U, I - V  # RR, RL, LR, LL


def _circ_to_stokes(RR, RL, LR, LL, nstokes):
    out = np.stack([(RR + LL) / 2, (RL + LR) / 2,
                    (RL - LR) / 2j, (RR - LL) / 2], axis=-1)
    return out[..., :nstokes]


def apply_jones_corruption(vis, baselines, g_R, g_L, d_R, d_L, phi=None):
    """Corrupt Stokes visibilities with station Jones matrices.

    vis: (nscan, nbl, nstokes<=4) complex Stokes [I, Q, U, V];
    g_R/g_L: (nscan, ns); d_R/d_L: (ns,); phi: optional field-rotation
    angles (nscan, ns) radians (frcal=False). Computes
    rho' = J_i rho J_j^dagger in the circular basis with
    J = diag(gR, gL) @ [[1, dR], [dL, 1]] @ diag(e^{-i phi}, e^{+i phi}),
    then maps back to Stokes. Matches the reference's
    jones=True/inv_jones=True path where only the uncalibrated effects
    (gain errors, leakage, and — when frcal=False — field rotation)
    survive.
    """
    nstokes = vis.shape[-1]
    RR, RL, LR, LL = _stokes_to_circ(vis)
    i, j = baselines[:, 0], baselines[:, 1]

    if phi is not None:
        # F_i rho F_j^H with F = diag(e^{-i phi}, e^{+i phi})
        pi, pj = phi[:, i], phi[:, j]
        RR = RR * np.exp(1j * (pj - pi))
        RL = RL * np.exp(-1j * (pi + pj))
        LR = LR * np.exp(1j * (pi + pj))
        LL = LL * np.exp(1j * (pi - pj))

    dRi, dLi = d_R[i], d_L[i]
    dRj_c, dLj_c = np.conj(d_R[j]), np.conj(d_L[j])

    # M = D_i rho D_j^dagger
    M11 = RR + dRi * LR + (RL + dRi * LL) * dRj_c
    M12 = (RR + dRi * LR) * dLj_c + (RL + dRi * LL)
    M21 = dLi * RR + LR + (dLi * RL + LL) * dRj_c
    M22 = (dLi * RR + LR) * dLj_c + (dLi * RL + LL)

    gRi, gLi = g_R[:, i], g_L[:, i]
    gRj_c, gLj_c = np.conj(g_R[:, j]), np.conj(g_L[:, j])
    RRp = gRi * gRj_c * M11
    RLp = gRi * gLj_c * M12
    LRp = gLi * gRj_c * M21
    LLp = gLi * gLj_c * M22
    return _circ_to_stokes(RRp, RLp, LRp, LLp, nstokes)


def apply_inverse_jones(vis, baselines, g_R=None, g_L=None, d_R=None,
                        d_L=None, phi=None):
    """Calibrate Stokes visibilities with KNOWN station Jones terms:
    rho = J_i^{-1} rho' J_j^{-dagger} with J = G D F as in
    apply_jones_corruption. Pass only the terms to undo (e.g. known
    D-terms + field-rotation angles while leaving gain errors in) —
    the ehtim inv_jones calibration step (reference
    observation.py:183-185 jones=True/inv_jones=True).
    """
    vis = np.asarray(vis, complex)
    nstokes = vis.shape[-1]
    RR, RL, LR, LL = _stokes_to_circ(vis)
    i, j = baselines[:, 0], baselines[:, 1]

    if g_R is not None:
        gRi, gLi = g_R[:, i], g_L[:, i]
        gRj_c, gLj_c = np.conj(g_R[:, j]), np.conj(g_L[:, j])
        RR = RR / (gRi * gRj_c)
        RL = RL / (gRi * gLj_c)
        LR = LR / (gLi * gRj_c)
        LL = LL / (gLi * gLj_c)

    if d_R is not None:
        # D^{-1} = [[1, -dR], [-dL, 1]] / (1 - dR dL)
        dRi, dLi = d_R[i], d_L[i]
        dRj_c, dLj_c = np.conj(d_R[j]), np.conj(d_L[j])
        det_i = 1.0 - dRi * dLi
        det_j_c = np.conj(1.0 - d_R[j] * d_L[j])
        M11 = RR - dRi * LR
        M12 = RL - dRi * LL
        M21 = LR - dLi * RR
        M22 = LL - dLi * RL
        # right factor (D_j^dagger)^{-1} = [[1, -dLj_c], [-dRj_c, 1]]/det
        RR = (M11 - M12 * dRj_c) / (det_i * det_j_c)
        RL = (M12 - M11 * dLj_c) / (det_i * det_j_c)
        LR = (M21 - M22 * dRj_c) / (det_i * det_j_c)
        LL = (M22 - M21 * dLj_c) / (det_i * det_j_c)

    if phi is not None:
        pi, pj = phi[:, i], phi[:, j]
        RR = RR * np.exp(-1j * (pj - pi))
        RL = RL * np.exp(1j * (pi + pj))
        LR = LR * np.exp(-1j * (pi + pj))
        LL = LL * np.exp(-1j * (pi - pj))
    return _circ_to_stokes(RR, RL, LR, LL, nstokes)


def observe_same(movie, times_hr, psize, obs, thermal_noise=True,
                 station_noise=False, dterm_noise=False, sigmat=0.25,
                 seed=False, dterm_offset=0.05, ampcal=None, phasecal=None,
                 frcal=True, dcal=None, stabilize_scan_amp=True,
                 stabilize_scan_phase=True, rlgaincal=False,
                 neggains=False):
    """Observe a movie with the array: DFT sampling + noise corruption
    (reference observation.py:121-187 wrapping ehtim observe_same).

    movie: (nt, [nstokes,] ny, nx) Jy/pixel; times_hr: frame times;
    psize: pixel size in radians. Returns a new Observation with vis.

    Noise tiers match the reference: thermal (radiometer sigma),
    station gains/phases (scan-stabilized, Gauss-Markov correlation time
    `sigmat` hours), and Jones D-term polarization leakage of std
    `dterm_offset` when dterm_noise=True.

    The ehtim toggle surface (reference observation.py:160-180) is
    exposed explicitly: ampcal / phasecal default to `not station_noise`
    (False = apply the respective gain errors); dcal defaults to
    `not dterm_noise` (False = apply leakage); frcal=False applies the
    elevation/parallactic field-rotation Jones terms from the station
    table (uncalibrated feed rotation — relevant for polarized-EHT
    fidelity), which apply_inverse_jones can undo with the known
    angles; stabilize_scan_amp/phase=False decorrelate the gain wander
    between scans; rlgaincal=True correlates the R/L feed gains;
    neggains=True draws one-sided (loss-only) gain offsets — both
    forwarded to station_jones (reference observation.py:167,171,184).
    """
    movie = np.asarray(movie)
    if movie.ndim == 3:
        movie = movie[:, None]
    nt_m, nstokes, ny, nx = movie.shape
    rng = np.random.default_rng(None if seed is False else seed)
    dcal = (not dterm_noise) if dcal is None else dcal

    # scan -> nearest frame (ehtim movie sampling)
    frame_of_scan = obs.scan_frame_assignment(times_hr)

    vis = np.zeros((obs.nscan, obs.nbl, nstokes), complex)
    for s in range(obs.nscan):
        val = obs.mask[s]
        if not val.any():
            continue
        A = dft_matrix(obs.u[s, val], obs.v[s, val], psize * nx, nx,
                       image_fov_y=psize * ny, image_size_y=ny)
        frame = movie[frame_of_scan[s]].reshape(nstokes, -1)
        vis[s, val] = (A @ frame.T)

    apply_gains = (station_noise or ampcal is False
                   or phasecal is False)
    apply_dterms = not dcal
    applied = None
    if apply_gains or apply_dterms or not frcal:
        g_R, g_L, d_R, d_L = station_jones(
            obs, rng, station_noise=station_noise,
            dterm_noise=apply_dterms, sigmat=sigmat,
            dterm_offset=dterm_offset, ampcal=ampcal, phasecal=phasecal,
            stabilize_scan_amp=stabilize_scan_amp,
            stabilize_scan_phase=stabilize_scan_phase,
            rlgaincal=rlgaincal, neggains=neggains)
        phi = None if frcal else field_rotation_angles(obs)
        vis = apply_jones_corruption(vis, obs.baselines, g_R, g_L,
                                     d_R, d_L, phi=phi)
        # keep the drawn tables (the ehtim caltable analog, reference
        # observation.py:121,133) so the corruption is recoverable
        applied = AppliedJones(g_R=g_R, g_L=g_L, d_R=d_R, d_L=d_L,
                               phi=phi)

    if thermal_noise:
        noise = (rng.standard_normal(vis.shape)
                 + 1j * rng.standard_normal(vis.shape))
        vis = vis + obs.sigma[..., None] * noise

    vis[~obs.mask] = np.nan
    return dataclasses.replace(obs, vis=vis,
                               pol_names=('I', 'Q', 'U', 'V')[:nstokes],
                               applied_jones=applied)


def padded_obs(obs, field, fill_value=np.nan):
    """Ragged per-scan field -> dense (nscan, max_nuv) matrix
    (reference observation.py:189-207)."""
    obslist = obs.tlist()
    max_num_uv = max(len(rec[field]) for rec in obslist)
    dtype = np.asarray(obslist[0][field]).dtype
    out = np.full((len(obslist), max_num_uv), fill_value, dtype=dtype)
    for i, rec in enumerate(obslist):
        out[i, :len(rec[field])] = rec[field]
    return out


@dataclasses.dataclass
class StokesMovie:
    """Lightweight Stokes movie container (ehtim.Movie stand-in used by
    the reference export path, observation.py:209-219). frames are
    (nt, nstokes, ny, nx) in Jy/pixel."""

    frames: np.ndarray
    times: np.ndarray       # UT hours
    psize: float            # radians / pixel
    ra: float = SGRA_RA
    dec: float = SGRA_DEC
    rf: float = SGRA_RF
    mjd: int = 57850
    pol_names: tuple = ('I', 'Q', 'U', 'V')

    def observe_same(self, obs, **kwargs):
        return observe_same(self.frames, self.times, self.psize, obs,
                            **kwargs)


def stokes_array_to_ehtim(movie, times, psize, ra=SGRA_RA, dec=SGRA_DEC,
                          rf=SGRA_RF, mjd=57850):
    """(nt, nstokes, ny, nx) array -> StokesMovie
    (reference observation.py:209-219; ehtim is not a dependency, so
    the returned container implements the observe_same surface natively).
    """
    movie = np.asarray(movie)
    if movie.ndim != 4:
        raise ValueError(f'movie ndim={movie.ndim} not supported')
    return StokesMovie(movie, np.asarray(times), psize, ra, dec, rf, mjd)


def plot_uv_coverage(obs, ax=None, fontsize=14, s=None, cmap='rainbow',
                     add_conjugate=True, xlim=(-9.5, 9.5),
                     ylim=(-9.5, 9.5), shift_initial_time=True, cbar=True,
                     cmap_ticks=(0, 4, 8, 12), time_units='Hrs'):
    """uv-coverage scatter (reference observation.py:11-77)."""
    import matplotlib.pyplot as plt
    giga = 1e9
    recs = obs.tlist()
    u = np.concatenate([r['u'] for r in recs]) / giga
    v = np.concatenate([r['v'] for r in recs]) / giga
    t = np.concatenate([r['time'] for r in recs])
    if shift_initial_time and len(t):
        t = t - t.min()
    if add_conjugate:
        u, v, t = np.concatenate([u, -u]), np.concatenate([v, -v]), \
            np.concatenate([t, t])
    if ax is None:
        fig, ax = plt.subplots(1, 1)
    else:
        fig = ax.get_figure()
    if time_units == 'mins':
        t = t * 60.0
    sc = ax.scatter(u, v, c=t, cmap=plt.get_cmap(cmap), s=s)
    ax.set_xlabel(r'East-West Freq $[G \lambda]$', fontsize=fontsize)
    ax.set_ylabel(r'North-South Freq $[G \lambda]$', fontsize=fontsize)
    ax.invert_xaxis()
    ax.set_xlim(xlim)
    ax.set_ylim(ylim)
    ax.set_aspect('equal')
    if cbar:
        from mpl_toolkits.axes_grid1 import make_axes_locatable
        divider = make_axes_locatable(ax)
        cax = divider.append_axes('right', size='3.5%', pad=0.2)
        cb = fig.colorbar(sc, cax=cax, ticks=list(cmap_ticks))
        cb.set_ticklabels([f'{tick} {time_units}'
                           for tick in cb.get_ticks()])
    return ax
