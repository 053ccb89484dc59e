"""Pan-genome statistics: group x taxon matrix, rarefaction, curve fits.

Behavioral contract: reference scripts/pan_genome.py:
- group classification by #taxa present: <= Ts 'Specific', >= Tc 'Core',
  else 'Share', with Ts = max(ts*N, 1) (ts<1) and Tc = tc*N (:108-138);
- unclustered genes appended as singleton Specific groups (:161-188);
- rarefaction: random.seed(42), 20 random genome orderings accumulated
  one genome at a time (:274-346); new-gene count at step j uses the
  numexpr-absent fallback formula (ys <= Ts-1) & (yn > 0) (:327);
- fits: core Fc(n)=Kc*exp(-n/Tau)+Omega and new-genes Fs (bounds >= 0),
  pan size K*n^r (unbounded), via scipy curve_fit with dogbox fallback;
  95% CI from Student-t over sqrt(diag(pcov)) (:448-469);
- report: '#'-commented stats header, fitted parameters with chr(177)
  separators, then the per-group type/frequency table (:492-568).

Copied from ``swiftortho_tpu/analysis/pan_genome.py``: the port keeps its own copy of this
host module and imports nothing of the JAX package.
"""

from __future__ import annotations

import random
from typing import IO, Iterable, List

import numpy as np

from ..io_fasta import SeqDB


def build_matrix(db: SeqDB, cluster_lines: Iterable[str],
                 ts: float = 0.05, tc: float = 0.95, sep: str = '|',
                 tax_allow: set | None = None,
                 taxon_order: List[str] | None = None):
    """Returns (taxon_list, group_names, types, counts (G,N), spec/shar/core).

    taxon_order: explicit column order for the taxon axis.  The reference
    derives its column order from python set iteration (scripts/
    pan_genome.py:95-103), which is hash-dependent; we default to
    first-appearance order (named deviation) but accept an explicit order
    so the parity tests can reproduce the reference's columns exactly.
    """
    taxa_all = db.taxa(sep)
    taxon_list = []
    seen = set()
    if taxon_order is not None:
        taxon_list = list(taxon_order)
        seen = set(taxon_list)
    for t in taxa_all:
        if tax_allow and t not in tax_allow:
            continue
        if t not in seen:
            seen.add(t)
            taxon_list.append(t)
    tdict = {t: i for i, t in enumerate(taxon_list)}
    N = len(taxon_list)
    Ts = max(ts * N, 1) if ts < 1 else ts
    Tc = tc * N if tc < 1 else tc

    rows: List[np.ndarray] = []
    names: List[str] = []
    types: List[str] = []
    spec = shar = core = 0
    visit = set()
    flag = 0
    for line in cluster_lines:
        counts = np.zeros(N, np.int32)
        for g in line.rstrip('\n').split('\t'):
            tax = g.split(sep)[0]
            if tax_allow and tax not in tax_allow:
                continue
            counts[tdict[tax]] += 1
            visit.add(g)
        thr = int((counts > 0).sum())
        if thr <= Ts:
            pan = 'Specific'
            spec += 1
        elif Ts < thr < Tc:
            pan = 'Share'
            shar += 1
        else:
            pan = 'Core'
            core += 1
        names.append('group_%09d' % flag)
        types.append(pan)
        rows.append(counts)
        flag += 1

    for gid in db.ids:
        if gid in visit:
            continue
        tax = gid.split(sep)[0]
        if tax_allow and tax not in tax_allow:
            continue
        counts = np.zeros(N, np.int32)
        counts[tdict[tax]] += 1
        names.append('group_%09d' % flag)
        types.append('Specific')
        rows.append(counts)
        flag += 1
        spec += 1

    mat = np.array(rows) if rows else np.zeros((0, N), np.int32)
    return taxon_list, names, types, mat, (spec, shar, core)


def rarefaction(mat: np.ndarray, size: int = 20, ts: float = 0.05,
                tc: float = 0.95):
    """Reference pan_feature with the numexpr-absent fallback formula."""
    mat = (mat > 0).astype(np.int8)
    n, d = mat.shape
    idx = list(range(d))
    random.seed(42)
    idxs = []
    for _ in range(size):
        random.shuffle(idx)
        idxs.append(idx[:])
    index, cores, specs, panzs = [], [], [], []
    ys = (mat[:, [e[0] for e in idxs]] > 0).astype(np.int32)
    for i in range(1, d):
        j = i + 1
        Ts = max(ts * j, 1) if ts < 1 else ts
        Tc = tc * j if tc < 1 else tc
        yn = (mat[:, [e[i] for e in idxs]] > 0).astype(np.int32)
        sp = ((ys <= Ts - 1) & (yn > 0)).astype(np.int8)
        spec = sp.sum(0)
        ys = ys + yn
        core = (ys >= Tc).sum(0)
        panz = (ys > 0).sum(0)
        cores.extend(core[:size])
        specs.extend(spec[:size])
        panzs.extend(panz[:size])
        index.extend([j] * size)
    return index, cores, specs, panzs


def _fc(n, K, Tau, Omega):
    return K * np.exp(-np.asarray(n, float) / Tau) + Omega


def _pgene(n, K, r):
    return K * np.asarray(n, float) ** r


def fit_curve(f, X, Y, alpha=0.05, bounds=None):
    from scipy.optimize import curve_fit
    from scipy.stats import t as tdist
    x, y = np.asarray(X, float), np.asarray(Y, float)
    kw = {'bounds': bounds} if bounds else {}
    try:
        pars, pcov = curve_fit(f, x, y, **kw)
    except Exception:
        pars, pcov = curve_fit(f, x, y, method='dogbox', **kw)
    dof = max(0, len(y) - len(pars))
    tval = tdist.ppf(1.0 - alpha / 2.0, dof)
    conf = [tval * e ** 0.5 for e in np.diag(pcov)]
    return pars, conf


_RCMD = '''#!usr/bin/env Rscript
dat<-read.delim('{fname}', sep='\\t', header=F)

end = {end}
y = dat$V2
x = dat$V1

# core genes
a = {a0_}
b = {b0_}
c = {c0_}
fc <- function(n)(a * exp(-n/b) + c)

pdf("{path}/pan_curve.pdf")
par(mfrow=c(2,2))

plot(x,y, xlab='# of genomes', ylab='# of core genes', pch=19)
lines(fc(1:end), col='red', lwd=3)

# new genes per sequenced
K_s = {a1_}
Tau_s = {b1_}
TgTheta = {c1_}
fs <- function(n)(K_s * exp(-n / Tau_s) + TgTheta)

y=dat$V3
x=dat$V1

plot(x,y, xlab='# of genomes', ylab='# of new genes', pch=19)
lines(fs(1:end), col='blue', lwd=3)

# pangenome size
K={a2_}
r={b2_}

fp <- function(n)(K * n ** r)

y=dat$V4
x=dat$V1

plot(x,y, xlab='# of genomes', ylab='size of pan-genome', pch=19)
lines(fp(1:end), col='green', lwd=3)

dev.off()

'''


def write_plot_files(prefix: str, index, cores, specs, panzs,
                     params) -> None:
    """Drop-in plot artifacts of the reference (pan_genome.py:384-389,
    579-637): ``<prefix>_xy.txt`` — the rarefaction medians — and
    ``plot_pan.rs`` next to it, the exact Rscript the reference renders.
    Deviation (env): no Rscript exists here, so the .rs file is KEPT for
    the user to run instead of executed-and-deleted (:630-637)."""
    import os
    with open(prefix + '_xy.txt', 'w') as o:
        for a, b, c, d in zip(index, cores, specs, panzs):
            o.write('%s\n' % '\t'.join(map(str, [a, b, c, d])))
    curdir = os.path.dirname(os.path.abspath(prefix)) or os.getcwd()
    rcmd = _RCMD.format(
        fname=os.path.abspath(prefix) + '_xy.txt',
        a0_=params[0], b0_=params[1], c0_=params[2],
        a1_=params[3], b1_=params[4], c1_=params[5],
        a2_=params[6], b2_=params[7],
        end=max(index), path=curdir)
    with open(os.path.join(curdir, 'plot_pan.rs'), 'w') as o:
        o.write(rcmd)


def pan_report(db: SeqDB, cluster_lines: Iterable[str], out: IO[str],
               ts: float = 0.05, tc: float = 0.95, sep: str = '|',
               tax_allow: set | None = None, rare_size: int = 20,
               taxon_order: List[str] | None = None,
               plot_prefix: str | None = None):
    taxon_list, names, types, mat, (spec, shar, core) = build_matrix(
        db, cluster_lines, ts, tc, sep, tax_allow, taxon_order)
    N = len(taxon_list)
    pm = chr(177)
    k_, t_, w_, theta, r_ = (chr(954), chr(964), chr(969), chr(952),
                             chr(947))
    w = out.write
    w('#' * 80 + '\n')
    w('# Statistics and profile of pan-genome:\n')
    w('# The methods can be found in Hu X, et al. Trajectory and genomic '
      'determinants of fungal-pathogen speciation and host adaptation.\n')
    w('#\n')
    w('# statistic of core, shared and specific genes:\n')
    w('\t'.join(['# Feature', 'core', 'shared', 'specific', 'taxon']) + '\n')
    w('\t'.join(map(str, ['# Number', core, shar, spec, N])) + '\n')

    if N >= 3 and len(mat):
        index, cores, specs, panzs = rarefaction(mat, rare_size, ts, tc)
        inf = np.inf
        params: List[float] = []
        try:
            w('#\n# %s(core size of pan-genome) and 95%% confidence '
              'interval:\n' % w_)
            popt, conf = fit_curve(_fc, index, cores,
                                   bounds=([0, 0, 0], [inf, inf, inf]))
            w('#\t%sc\t%sc\t%s\n' % (k_, t_, w_))
            w('# ' + '\t'.join(str(a) + pm + str(b)
                               for a, b in zip(popt, conf)) + '\n')
            params.extend(popt)
            w('#\n# %s(new gene number for each new sequenced genome) and '
              '95%% confidence interval:\n' % theta)
            popt, conf = fit_curve(_fc, index, specs,
                                   bounds=([0, 0, 0], [inf, inf, inf]))
            w('# %ss\t%ss\ttg(%s)\n' % (k_, t_, theta))
            w('# ' + '\t'.join(str(a) + pm + str(b)
                               for a, b in zip(popt, conf)) + '\n')
            params.extend(popt)
            w('#\n# %s(size and openess of pan-genome, open if %s > 0) and '
              '95%% confidence interval:\n' % (k_, r_))
            popt, conf = fit_curve(_pgene, index, panzs)
            w('# %s\t%s\n' % (k_, r_))
            w('# ' + '\t'.join(str(a) + pm + str(b)
                               for a, b in zip(popt, conf)) + '\n')
            params.extend(popt)
            if plot_prefix:
                write_plot_files(plot_prefix, index, cores, specs, panzs,
                                 params)
        except Exception as e:      # tiny corpora can defeat the fits
            w('# curve fitting skipped: %s\n' % e)

    w('#\n# Type and frequency of each gene group in different species:\n')
    w('#' * 80 + '\n')
    w('\t'.join(['#family', 'type'] + taxon_list) + '\n')
    for name, typ, row in zip(names, types, mat):
        w(name + '\t' + typ + '\t' + '\t'.join(map(str, row)) + '\n')
