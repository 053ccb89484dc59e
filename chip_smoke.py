#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (swiftortho_tpu_torch) on one card.

    python3 chip_smoke.py        # from the repository root, one CUDA card
    python3 chip_smoke.py --baseline old.cu   # also time an older source
    python3 chip_smoke.py --scale 250k        # the 252,608-sequence run

Builds the port's CUDA kernels from csrc/, holds the banded SW (full
statistics; score-only at 4 and at 8 lanes a pair) against the plain
PyTorch version and the port's C++ host oracle, times both variants at
two shapes beside the kernel's bound, and drives the port's paths on the
card, each checked against the JAX package's digests (pinned below,
computed with the JAX package on the CPU):

- the find_hit all-vs-all search at the size of the 10-genome
  configuration (41,168 sequences): the m8 table byte for byte, on the
  default route and on the device route (SWIFTORTHO_INDEX=device,
  SWIFTORTHO_CANDIDATES=device, SWIFTORTHO_DEVICE_PACK=force: index,
  candidates, pair packing and the wave body on the card), where every
  wave must run the device wave and report its host reads;
- the device routes on the 1,034-sequence corpus, each alone, all
  together, with a partial pair table and with a posting cap that cuts
  stage 2 into row blocks; and the device index and candidate engine on
  the 41k corpus against the host build and engine, array for array;
- the x-drop walk kernel (``walk_parity``) against the engine's plain
  walk (``walk_chunked``) on the card, bit for bit: both walks of the
  first stage-2 row block of that 41k wave and edge points, then both
  timed beside the kernel's bound; the device routes must launch it
  twice a row block;
- the accept-rounds kernel (``accept_parity``) against the engine's
  plain rounds (``accept_rounds``) on the card, bit for bit: the first
  stage-2 row block of that 41k wave and edge inputs, with no host read
  inside the kernel's call (``torch.cuda.set_sync_debug_mode('error')``),
  then both timed beside the kernel's bound; the device routes must
  launch it once a row block;
- find_orth on that table, and find_cluster on the orthology graph it
  writes (mcl on cuda and cpu, textbook apc and sap on cuda, twice each,
  and the host's faithful apc): output md5s;
- clustering at scale: a >=1.0M-edge planted-family graph through
  mcl_cluster, and a 20,480-node component through the block-sparse
  engine, twice, against the scipy oracle;
- run_all -A mcl on the 1,034-sequence corpus, in a child process that
  runs beside the search, clustering, multichunk and scale phases:
  .sc .opc .clsr .pan md5s;
  with SWIFTORTHO_TRACE_DIR set, its orth and cluster stages each write a
  torch.profiler trace, and the cluster trace must name a CUDA kernel
  (its top device operations by time are reported);
- the multi-device and multi-process paths (``multichip``): a 2-rank
  find_hit fleet on the 41k corpus (two processes joined through
  SWIFTORTHO_COORD on the one card; the merged .sc md5, each rank's half
  of the queries, SW launches in every wave, no part file left, each
  rank's search/barrier/merge seconds); blastp_sharded over a mesh of
  the card's devices and over the card repeated four times, with and
  without the pack route (the 1,034-sequence .sc md5, every pair packed);
  SWIFTORTHO_CANDIDATES=multidb with the reference in five chunks
  against the host route; demo_multichip on the card against the same
  step on the CPU (masked tokens byte for byte, the per-query max); seg
  of the 1,034 queries on the card against the CPU; find_cluster -a mcl
  under SWIFTORTHO_MCL_MESH=1 (the .clsr md5) and the sharded
  block-sparse expansion over the card repeated against one device;
- the streamed multi-chunk search (``multichunk``): the 41k corpus at
  ``-c 10000`` (five reference chunks) on the default route, through
  ``-p makedb`` and ``-D`` with strict streaming (no prefetch), blocks of
  two waves and a ``-T`` candidate spill that must end empty, and on the
  three device routes, each writing the JAX package's ``.sc`` for that
  chunking;
- the long-pair path (``long_pairs``): proteins of up to 8,857 residues,
  aligned in 4096-wide tiles: the JAX package's ``.sc``, tiles > 0,
  launches at width 4096;
- the scale pipeline (``scale``): ``tools.run_scale`` in a child process
  on the 102,681-sequence corpus (3 chunks, nc = 2^24): its ``.sc``,
  ``.opc`` and ``.clsr`` equal to the JAX package's ``tools/run_scale.py``
  with the same arguments, ``find_orth -L y`` byte-equal, every group
  family-pure; ``kernel_time_paths`` then times the kernel at the launch
  shapes of that run and of the long tiles (one round of turns: the
  plain version takes ~20 s a call at width 4096);
- the port's tools (``tools``): ``tools.scaling_bench`` at 1, 2 and 4
  ranks on the card (every fleet's .sc the JAX find_hit CLI's),
  ``tools.profile_phaseA`` at its defaults (the JAX tool's candidates per
  (wave, chunk); its corpus and index are written by a child that runs
  beside the clustering phases), ``tools.bench_device_cand`` (device and
  host candidates equal at each cap from 2^20 to 2^23) and
  ``tools/example_run.sh`` (in a child beside every earlier phase, on
  the card by default: rc 0 and the JAX CLI's ref.sc).

``kernel_time`` also times bench.py's host baseline (the C++ banded SW
on one core, 48 pairs at L = 500) and reports ``host_cells_per_s`` and
``vs_baseline`` on the full-statistics row at B = 4096, L = 500.

``--scale 250k`` runs, after the build, kernel parity and timing phases,
only the 252,608-sequence ``run_scale`` (6 chunks) against the JAX
script's digests, and times the kernel at its launch shapes.

``--baseline`` names an earlier source of ``csrc/banded_sw.cu`` (its C
entry ``swt_banded_sw`` must take today's arguments, as PR 1's does,
e.g. ``git show <commit>:swiftortho_tpu_torch/csrc/banded_sw.cu``):
``kernel_time`` builds it alone, requires its nine fields to equal the
kernel's at every timed shape, and times it in the same turns.

Imports no JAX and nothing of the JAX package (``swiftortho_tpu``): the
C++ oracle, the corpus and the pan-genome code are the port's own copies.
Each phase prints one JSON line: device, build, kernel_parity,
kernel_time, search_parity, device_search_parity, search,
device_components, walk_parity, accept_parity, search_device, orth,
cluster_parity, cluster_scale, multichip, pipeline, multichunk,
long_pairs, scale, kernel_time_paths, tools.  Any failed check exits
nonzero before the result lines; every child process has a timeout.  The
last three lines are the card's ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` line, the kernels JSON object (the banded SW's
two variants and, but with ``--scale``, whose path does not run the
device engine, the x-drop walk and the accept rounds) and {"ok": true,
"device": {...}}.
"""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules['jax'] = None           # this script and the port run without JAX
sys.modules['swiftortho_tpu'] = None    # ... and without the JAX package

T_START = time.time()
SOURCE = 'swiftortho_tpu_torch/csrc/banded_sw.cu'
REPLACES = 'swiftortho_tpu/ops/banded_sw_pallas.py:383'
# the x-drop walk kernel replaces plain JAX (no Pallas kernel): the
# device candidate engine's chunked walk
WALK_SOURCE = 'swiftortho_tpu_torch/csrc/xdrop_walk.cu'
WALK_REPLACES = 'swiftortho_tpu/search/candidates_device.py:169'
# the least integer operations of one walk step (bounds check 4, two
# token offsets 2, score index 1, running sum 1, best compare and
# select 2, x-drop compare 2) and the bytes of one point (eight int32
# and one int64 read, two int32 written); PERF.md lists them
WALK_OPS_PER_STEP = 12
WALK_POINT_BYTES = 48
# the accept-rounds kernel replaces plain JAX as well: the engine's
# while_loop of segmented scans over a row block's points
ACCEPT_SOURCE = 'swiftortho_tpu_torch/csrc/accept_rounds.cu'
ACCEPT_REPLACES = 'swiftortho_tpu/search/candidates_device.py:241'
# the least bytes of one point (two bool flags read, a bool and an int32
# qlo_rec written: 7), with an int32 qst read for a valid point and an
# int32 E for an accepted one (the JAX reference's width), and its least
# integer operations (the flag test, the validity test, the cover
# compare, the max, the count); PERF.md lists them
ACCEPT_POINT_BYTES = 7
ACCEPT_VALID_BYTES = 4
ACCEPT_ACCEPTED_BYTES = 4
ACCEPT_OPS_PER_POINT = 5
# the 10-genome configuration of BASELINE.md and its m8 digest from the
# JAX package (host path, SearchConfig defaults = CLI defaults)
BIG = dict(n_taxa=10, n_families=4000, seed=42)
BIG_FSA_MD5 = '74dfa541398b2b45d0cd463101066c7b'
BIG_SC_MD5 = 'a981540b1f2f3d648950f053de352f92'
SMALL = dict(n_taxa=5, n_families=200, seed=7)
SMALL_FSA_MD5 = 'a427a30efdd8e463cf4d44af2510ff7f'
SMALL_SC_MD5 = '25358fa86cbd285a852832f33e51f09c'
# the JAX package's find_orth (defaults) on the 41k table, and its
# find_cluster (defaults) on the graph that writes
BIG_OPC_MD5 = '325563182e8728eef0689529561ec99a'
BIG_CLSR_MD5 = {'mcl': 'e47d40247535bcad66cd4447e4e26efc',
                'apc_textbook': '6ef671195edc9e21fb3923fc001625a5',
                'sap': 'ddede1a9d5d7c8d81523b872579d7981',
                'apc_faithful': '8dd8a02e583249e1b56d992e39e7cf9e'}
# the JAX package's run_all -A mcl on SMALL (no external tools on PATH;
# scipy 1.17.0, numpy 2.0.2).  The .pan's three curve-fit lines (the
# ones holding '±') carry scipy.optimize.curve_fit results, which move
# with the scipy build; PAN_NOFIT_MD5 is the digest without them, and
# the whole .pan is also held against the port's copy of the JAX
# package's stage-4 code (analysis.pan_genome.pan_report) run here.
PIPE_MD5 = {'sc': 'b0c46bb9013002fcb19c72c5eb4b101d',
            'opc': 'd287115f4a9767e736a6ad7118eeea6d',
            'clsr': 'ed3a8913b92608542fdca4baf705d4c9'}
PAN_MD5 = '9961b88eba3aa29364d9491ac250c9b8'
PAN_NOFIT_MD5 = '95ae2bf7d43a0a656f2ef1c295749f49'
PIPE_NWK_MD5_NO_TOOLS = 'dededa9ff50bd04ac09bfada7d194d5f'
SCALE_FAMILIES, SCALE_CHAIN, CLIQUE = 5200, 225, 20
SCALE_MIN_EDGES = 1_000_000
BIG_COMPONENT_CLIQUES, BIG_COMPONENT_MB = 1024, 1024    # 20,480 nodes
# multichip: ranks of the find_hit fleet, the seconds a rank may take, the
# reference chunk size that cuts SMALL into five multi-db shards, and the
# component the sharded expansion runs on (128 cliques of 20, mb = 256)
FLEET_RANKS, FLEET_TIMEOUT = 2, 600
MULTIDB_CHUNK = 250
MESH_COMPONENT_CLIQUES, MESH_COMPONENT_MB = 128, 256
# kernel parity: B = 1000 pairs at each length (score-only runs at 8
# lanes a pair there), and one batch of 8,192 (score-only at 4 lanes)
PARITY_LENGTHS = (128, 500, 1536, 4096)
PARITY_WIDE = (8192, 400)
# kernel timing, (B, L) per variant: the bench.py shape, then the 41k
# search's launch size (pairs over launches: 427,044 / 33 full,
# 7,141,009 / 33 score-only; lengths up to 407)
TIME_SHAPES = {'full': ((4096, 500), (12941, 400)),
               'score_only': ((4096, 500), (216394, 400))}
BAND = 32
# multichunk: the 41k corpus at -c 10000 (five reference chunks) and the
# JAX package's find_hit .sc for it; makedb / -D with strict streaming in
# blocks of two waves and a candidate spill, then the three device routes
MULTICHUNK = 10000
BIG_C10000_SC_MD5 = '51a2379dce9c095f2fe1497428b13daa'
MULTICHUNK_CHUNKS = 5
# long_pairs: 125 proteins of 1,000-9,000 residues (64 of them >= 4096):
# the 4096-wide tile path; the JAX package's find_hit .sc (defaults)
LONG = dict(n_taxa=5, n_families=24, seed=5, min_len=1000, max_len=9000)
LONG_FSA_MD5 = '16223dccc8107867876a458d89787c19'
LONG_SC_MD5 = 'a4ce2486c106caa13604275cb99c337c'
# scale: tools.run_scale in a child process, against the JAX package's
# tools/run_scale.py with the same arguments (its workdir's md5s and
# counts); 102k runs in the default call, 250k behind --scale 250k
SCALE = {
    '102k': {'args': ['--taxa', '25', '--families', '4000', '--max-len',
                      '400', '--seed', '7', '--orth-out-of-core'],
             'md5': {'fsa': 'e2ab91216e45768779b9d819565393a0',
                     'sc': 'a12ed29301bbb5499eeff383d77f7215',
                     'opc': 'a6d9b2b810f834bc6bc85d79729ff5be',
                     'clsr': 'b94c30436c0dd96f0b6d556602663f0c'},
             'counts': {'sequences': 102681, 'chunks': 3,
                        'sc_rows': 2639533, 'opc_edges': 1084890,
                        'clsr_groups': 4012, 'genes_clustered': 99908},
             'timeout': 900},
    '250k': {'args': ['--taxa', '60', '--families', '4100', '--max-len',
                      '400', '--seed', '7', '--route', 'default'],
             'md5': {'fsa': 'b98cd535179cb3fb9c9228bddb1692df',
                     'sc': '4a0f342d294c67b0ce46d8e3e5ea2a51',
                     'opc': '849b0dc126fed687429937433fe1e174',
                     'clsr': 'e3b31bb947ea4c9328f5496c265ae41d'},
             'counts': {'sequences': 252608, 'chunks': 6,
                        'sc_rows': 15541329, 'opc_edges': 6555026,
                        'clsr_groups': 4139, 'genes_clustered': 247572},
             'timeout': 2700,
             # BASELINE.md:489-490, the JAX package's published run
             'published': {'sc_rows': 15.54e6, 'opc_edges': 6.56e6,
                           'clsr_groups': 4139,
                           'genes_clustered': 247572,
                           'sequences': 252608}},
}
# the least integer operations per band cell of the recurrence, the
# count the bound uses; PERF.md lists them term by term
INT_OPS_PER_CELL = {'full': 24, 'score_only': 10}
# bench.py's host baseline: the C++ kernel on one core, 48 pairs of the
# kernel_time shape (B = 4096, L = 500, full statistics)
HOST_BASELINE_PAIRS, HOST_BASELINE_SHAPE = 48, (4096, 500)
# tools: the port's tools/ against the JAX package's, pinned here from
# the JAX package on the CPU.  scaling_bench's corpus (--seqs 2000) and
# the find_hit CLI's .sc on it (-e 1e-5 -M 262144); profile_phaseA's
# corpus at its defaults (102,844 sequences, 3 chunks at nc = 2^24) and
# the JAX tool's candidates per (wave, chunk); example_run.sh's ref.sc
# (the JAX find_hit CLI with the script's flags)
SCALING_PROCS = (1, 2, 4)
SCALING_FSA_MD5 = '4e684fe531d410af7d27f8ef92bbee61'
SCALING_SC_MD5 = '3a26146b9111f5dfb4557e019edd6d52'
PHASEA_FSA_MD5 = 'a488f408e5b4c3fe59a57600500c462e'
PHASEA_CANDS = [[4945027, 5036340, 331739], [4960367, 5053483, 334898]]
EXAMPLE_SC_MD5 = '4591a54f692e6975a57025d43d0836de'
DEVICE_CAND_CAPS = [1 << k for k in (20, 21, 22, 23)]


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError('check failed: ' + msg)


def md5(path):
    with open(path, 'rb') as f:
        return hashlib.md5(f.read()).hexdigest()


def phase_device(torch):
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: torch.cuda.is_available() is False; '
                 'this script needs a CUDA card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          'nvidia-smi failed: %s' % smi.stderr.strip())
    smi_line = smi.stdout.strip().splitlines()[0].strip()
    dev = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
           'count': torch.cuda.device_count()}
    emit('device', **dev, nvidia_smi=smi_line, torch=torch.__version__,
         cuda=torch.version.cuda)
    return dev, smi_line


def ptxas_summary(lines):
    """Registers, shared memory and spill bytes per kernel (banded SW:
    statistics on/off, lanes per pair; the x-drop walk: one thread a
    point; the accept rounds: one thread a segment) from the ptxas report
    lines."""
    import re
    out, cur = [], None
    for ln in lines:
        m = re.search(r'banded_sw_kernelILb([01])ELi(\d+)E', ln)
        if 'Compiling entry' in ln and m:
            cur = {'variant': 'full' if m.group(1) == '1' else 'score_only',
                   'lanes': int(m.group(2))}
            out.append(cur)
        elif 'Compiling entry' in ln and 'xdrop_walk_kernel' in ln:
            cur = {'variant': 'xdrop_walk', 'lanes': 1}
            out.append(cur)
        elif 'Compiling entry' in ln and 'accept_rounds_kernel' in ln:
            cur = {'variant': 'accept_rounds', 'lanes': 1}
            out.append(cur)
        elif cur is not None:
            for key, pat in (('registers', r'Used (\d+) registers'),
                             ('smem_bytes', r'(\d+) bytes smem'),
                             ('spill_stores', r'(\d+) bytes spill stores'),
                             ('spill_loads', r'(\d+) bytes spill loads')):
                m = re.search(pat, ln)
                if m:
                    cur[key] = int(m.group(1))
    return out


KERNELS = [('full', 4), ('score_only', 4), ('score_only', 8)]


def phase_build():
    import threading
    from swiftortho_tpu_torch import _build, native
    t0 = time.time()
    # the host library (g++, the C++ oracle and host kernels) builds
    # beside nvcc; a failure there raises again at its first use
    host = threading.Thread(target=native.load, daemon=True)
    host.start()
    _build.load_kernels()
    host.join()
    info = _build.build_info()
    kernels = ptxas_summary(info['ptxas'])
    built = KERNELS + [('xdrop_walk', 1), ('accept_rounds', 1)]
    check(sorted((k['variant'], k['lanes']) for k in kernels)
          == sorted(built) and all('registers' in k for k in kernels),
          'ptxas report lacks the kernels %s: %s' % (built, info['ptxas']))
    emit('build', seconds=round(time.time() - t0, 3), built=info['built'],
         nvcc_seconds=info['seconds'], command=info['command'],
         kernels=kernels, ptxas=info['ptxas'])


def related_batch(np, rng, B, L):
    """B pairs of width L with lengths in [L/2, L]: a quarter unrelated,
    the rest substituted (30%) and shifted copies, so the best paths
    carry gaps, mismatches and border runs."""
    AA = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWY', np.uint8)
    t0 = AA[rng.integers(0, 20, (B, L))]
    t1 = t0.copy()
    sub = rng.random((B, L)) < 0.3
    t1[sub] = AA[rng.integers(0, 20, int(sub.sum()))]
    shift = rng.integers(-6, 7, B)
    t1 = np.take_along_axis(
        t1, (np.arange(L)[None, :] - shift[:, None]) % L, axis=1)
    far = rng.random(B) < 0.25
    t1[far] = AA[rng.integers(0, 20, (int(far.sum()), L))]
    l0 = rng.integers(L // 2, L + 1, B).astype(np.int32)
    l1 = rng.integers(L // 2, L + 1, B).astype(np.int32)
    return t0, t1, l0, l1


def edge_batch(np, rng):
    """Empty and tiny pairs, identical sequences, asymmetric lengths and
    the lowercase/junk alphabet; B = 37 leaves half a warp idle."""
    AA = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWY', np.uint8)
    JUNK = np.frombuffer(b'acdefghiklmnpqrstvwyXJ*-', np.uint8)
    B, L = 37, 64
    t0 = AA[rng.integers(0, 20, (B, L))]
    t1 = AA[rng.integers(0, 20, (B, L))]
    lens = [(0, 0), (0, 5), (5, 0), (1, 1), (1, 3), (2, 2), (3, 1),
            (40, 40), (64, 64), (3, 60), (60, 3), (17, 64), (64, 17)]
    l0 = rng.integers(0, L + 1, B).astype(np.int32)
    l1 = rng.integers(0, L + 1, B).astype(np.int32)
    for r, (a, b) in enumerate(lens):
        l0[r], l1[r] = a, b
    t1[7:9] = t0[7:9]                               # identical sequences
    t0[20:] = JUNK[rng.integers(0, len(JUNK), (B - 20, L))]
    t1[20:] = JUNK[rng.integers(0, len(JUNK), (B - 20, L))]
    t1[30:] = t0[30:]
    return t0, t1, l0, l1


def phase_kernel_parity(np, torch):
    from swiftortho_tpu_torch import _build
    from swiftortho_tpu_torch.native import sw_align_batch_native
    from swiftortho_tpu_torch.ops import banded_sw as bsw
    from swiftortho_tpu_torch.ops import banded_sw_cuda as cu
    rng = np.random.default_rng(2024)
    batches = [('L%d' % L, related_batch(np, rng, 1000, L))
               for L in PARITY_LENGTHS] + [('edge', edge_batch(np, rng))]
    batches.append(('B%d_L%d' % PARITY_WIDE,
                    related_batch(np, rng, *PARITY_WIDE)))
    lib = _build.load_kernels()
    max_err = {'full': 0, 'score_only': 0}
    cu.reset_counters()
    rows = []
    for name, batch in batches:
        t0 = time.time()
        dev = [torch.from_numpy(x).cuda() for x in batch]
        oracle = sw_align_batch_native(*batch)
        want = np.stack([oracle[k] for k in bsw.FIELDS]).astype(np.int64)
        plain = bsw.sw_align_batch(*dev)
        plain = torch.stack([plain[k] for k in bsw.FIELDS]).cpu().numpy()
        check(np.array_equal(plain, want),
              '%s: plain version on the card != C++ oracle' % name)
        full = cu.sw_align_batch_cuda(*dev).cpu().numpy()
        so = cu.sw_align_batch_cuda(*dev, score_only=True).cpu().numpy()
        torch.cuda.synchronize()
        bad = [k for i, k in enumerate(bsw.FIELDS)
               if not np.array_equal(full[i], plain[i])]
        check(not bad, '%s: kernel != plain in %s' % (name, bad))
        check(np.array_equal(so[:3], plain[:3]) and not so[3:].any(),
              '%s: score-only kernel != plain score/bi/bj or stats != 0'
              % name)
        max_err['full'] = max(max_err['full'], int(
            np.abs(full.astype(np.int64) - plain).max()))
        max_err['score_only'] = max(max_err['score_only'], int(
            np.abs(so[:3].astype(np.int64) - plain[:3]).max()))
        B = len(batch[0])
        rows.append({'batch': name, 'B': B,
                     'L': [batch[0].shape[1], batch[1].shape[1]],
                     'lanes': {'full': lib.swt_lanes_for(B, 0),
                               'score_only': lib.swt_lanes_for(B, 1)},
                     'max_score': int(want[0].max()),
                     'seconds': round(time.time() - t0, 2)})
    n = len(batches)
    check(cu.launches['full'] == n and cu.launches['score_only'] == n,
          'launch counters did not move: %s' % cu.launches)
    ran = {(v, r['lanes'][v]) for r in rows for v in ('full', 'score_only')}
    check(ran == set(KERNELS), 'parity ran the kernels %s, not %s'
          % (sorted(ran), KERNELS))
    emit('kernel_parity', batches=rows, tolerance=0, max_abs_err=max_err,
         launches=dict(cu.launches))
    return max_err


def card_rates(torch):
    """The int32 ALU rate the bound uses (SMs x 64 lanes x the max SM
    clock) and the memory rate of an H100 SXM (3.35 TB/s, the data
    sheet)."""
    smi = subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                          '--format=csv,noheader,nounits'],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, 'nvidia-smi clocks.max.sm failed')
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {'sms': sms, 'max_sm_mhz': mhz,
            'int_ops_per_s': sms * 64 * mhz * 1e6, 'bytes_per_s': 3.35e12}


def timed_ms(torch, fn, n):
    """Milliseconds a call of ``fn``, over ``n`` calls between two CUDA
    events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def sw_bound(rates, B, pad0, pad1, cells, var):
    """The least time for one call: the larger of the integer operations
    (INT_OPS_PER_CELL per band cell) over the ALU rate and the bytes (the
    tokens and lengths read once, the (9, B) result written once) over
    the memory rate."""
    ops_ms = cells * INT_OPS_PER_CELL[var] / rates['int_ops_per_s'] * 1e3
    nbytes = B * (pad0 + pad1) + 8 * B + 9 * 4 * B
    bytes_ms = nbytes / rates['bytes_per_s'] * 1e3
    return (max(ops_ms, bytes_ms),
            'operations' if ops_ms >= bytes_ms else 'bytes')


def build_baseline(path):
    """nvcc an earlier source of the kernel alone, with the port's flags,
    into the build directory; returns (its library, the ptxas lines)."""
    import ctypes
    from swiftortho_tpu_torch import _build
    with open(path, 'rb') as f:
        src = f.read()
    so = os.path.join(_build.BUILD_DIR, 'libswt_baseline.%s.so'
                      % hashlib.sha256(src).hexdigest()[:16])
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                        os.path.abspath(path), '-o', so],
                       capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, 'nvcc failed on %s:\n%s'
          % (path, r.stderr[-4000:]))
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.swt_banded_sw.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, ci, ci,
                                  ci, vp, vp]
    lib.swt_banded_sw.restype = ci
    return lib, _build._ptxas_lines(r.stdout + r.stderr)


HOST_CHILD = r"""
import json, sys, time
sys.modules['jax'] = None
sys.modules['swiftortho_tpu'] = None
import numpy as np
from swiftortho_tpu_torch.native import sw_align_batch_native
n, L = int(sys.argv[1]), int(sys.argv[2])
rng = np.random.default_rng(0)
AA = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWY', np.uint8)
t0 = AA[rng.integers(0, 20, (n, L + 12))]
t1 = AA[rng.integers(0, 20, (n, L + 12))]
lens = np.full(n, L, np.int32)
sw_align_batch_native(t0, t1, lens, lens)          # warm (builds the .so)
tt = time.time()
r = sw_align_batch_native(t0, t1, lens, lens)
dt = time.time() - tt
print(json.dumps({'cells_per_s': n * L * 32 / dt, 'seconds': dt,
                  'chk': int(r['score'].sum())}))
"""


def host_baseline():
    """bench.py's host baseline (its _cpu_worker): the port's C++ banded
    SW (``native.sw_align_batch_native``, full statistics) on one core
    (SWNATIVE_THREADS=1, in a child so that the count takes effect) over
    HOST_BASELINE_PAIRS pairs of width L; returns its result line."""
    r = subprocess.run(
        [sys.executable, '-c', HOST_CHILD, str(HOST_BASELINE_PAIRS),
         str(HOST_BASELINE_SHAPE[1])], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, SWNATIVE_THREADS='1'),
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(r.returncode == 0 and r.stdout.strip(),
          'host baseline child exited %s: %s' % (r.returncode,
                                                  r.stderr[-2000:]))
    res = json.loads(r.stdout.strip().splitlines()[-1])
    check(res['cells_per_s'] > 0, 'host baseline measured %s' % res)
    return dict(res, pairs=HOST_BASELINE_PAIRS, threads=1)


def phase_kernel_time(np, torch, baseline=None, shapes=None,
                      phase='kernel_time', rounds=2, plain_once=False):
    """Each variant at its TIME_SHAPES (or ``shapes``, in the same form):
    the kernel, the plain version and, with ``baseline``, an earlier
    source of the kernel, in turns (plain, kernel, baseline, baseline,
    kernel, plain, ``rounds`` times), with CUDA events; beside the bound.
    With ``plain_once`` the plain version is timed on its warm-up call
    only (it takes seconds a call at the wide path shapes).
    The first calls (warm-up) must agree field for field.  At TIME_SHAPES
    the full-statistics row at bench.py's shape also carries the host
    baseline (``host_cells_per_s``) and ``vs_baseline``, the kernel's
    cells/s over it, as bench.py reports them.  Returns each variant's
    row at its last shape (TIME_SHAPES: the main path's)."""
    from swiftortho_tpu_torch import _build
    from swiftortho_tpu_torch.constants import GAP_EXTEND, GAP_OPEN
    from swiftortho_tpu_torch.ops import banded_sw as bsw
    from swiftortho_tpu_torch.ops import banded_sw_cuda as cu
    rates = card_rates(torch)
    lib = _build.load_kernels()
    base, base_ptxas = build_baseline(baseline) if baseline else (None, None)
    host = host_baseline() if shapes is None else None
    table = bsw.scoring_tables(torch.device('cuda'))['codes']

    def run_base(dev, so):
        B, pad0 = dev[0].shape
        out = torch.empty((len(bsw.FIELDS), B), dtype=torch.int32,
                          device='cuda')
        rc = base.swt_banded_sw(*(x.data_ptr() for x in dev), B, pad0,
                                dev[1].shape[1], table.data_ptr(), GAP_OPEN,
                                GAP_EXTEND, int(so), out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, 'baseline launch failed: CUDA error %d' % rc)
        return out

    rows, main = [], {}
    for var, var_shapes in (shapes or TIME_SHAPES).items():
        so = var == 'score_only'
        for B, L in var_shapes:
            rng = np.random.default_rng(0)
            AA = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWY', np.uint8)
            t0 = AA[rng.integers(0, 20, (B, L + 12), dtype=np.uint8)]
            t1 = AA[rng.integers(0, 20, (B, L + 12), dtype=np.uint8)]
            lens = np.full(B, L, np.int32)
            dev = [torch.from_numpy(x).cuda() for x in (t0, t1, lens, lens)]
            cells = B * L * BAND
            reps = max(3, int(2e9 // cells))
            fns = {'plain': (lambda: bsw.sw_align_batch(*dev, score_only=so),
                             1),
                   'kernel': (lambda: cu.sw_align_batch_cuda(
                       *dev, score_only=so), reps)}
            if base is not None:
                fns['baseline'] = (lambda: run_base(dev, so), reps)
            # warm-up (build, caches, clocks), and the outputs compared
            plain_ev = [torch.cuda.Event(enable_timing=True)
                        for _ in range(2)]
            plain_ev[0].record()
            plain = fns['plain'][0]()
            plain_ev[1].record()
            plain = torch.stack([plain[k] for k in bsw.FIELDS]).to(
                torch.int32)
            got = {k: fn() for k, (fn, _) in fns.items() if k != 'plain'}
            torch.cuda.synchronize()
            nf = 3 if so else len(bsw.FIELDS)
            for k, out in got.items():
                check(torch.equal(out[:nf], plain[:nf])
                      and not out[nf:].any(),
                      '%s %dx%d: %s != plain' % (var, B, L, k))
            order = ['plain', 'kernel', 'baseline', 'baseline', 'kernel',
                     'plain']
            order = [k for k in order if k in fns
                     and not (plain_once and k == 'plain')]
            samples = {k: [] for k in fns}
            if plain_once:
                samples['plain'].append(plain_ev[0].elapsed_time(plain_ev[1]))
            for _ in range(rounds):
                for k in order:
                    fn, n = fns[k]
                    samples[k].append(timed_ms(torch, fn, n))
            ms = {k: sorted(v)[len(v) // 2] for k, v in samples.items()}
            bound_ms, bound_by = sw_bound(rates, B, L + 12, L + 12, cells,
                                          var)
            row = {'variant': var, 'B': B, 'L': L, 'band': BAND,
                   'cells': cells, 'lanes': lib.swt_lanes_for(B, int(so)),
                   'ms': ms['kernel'], 'plain_ms': ms['plain'],
                   'bound_ms': bound_ms, 'bound_by': bound_by,
                   'bound_share': bound_ms / ms['kernel'],
                   'cells_per_s': cells / (ms['kernel'] / 1e3),
                   'plain_cells_per_s': cells / (ms['plain'] / 1e3),
                   'samples_ms': samples}
            if base is not None:
                row['baseline_ms'] = ms['baseline']
                row['baseline_cells_per_s'] = cells / (ms['baseline'] / 1e3)
            if host is not None and not so \
                    and (B, L) == HOST_BASELINE_SHAPE:
                row['host_cells_per_s'] = host['cells_per_s']
                row['vs_baseline'] = row['cells_per_s'] / host['cells_per_s']
            rows.append(row)
            main[var] = row                 # the last shape: the main path's
    extra = {'baseline': baseline, 'baseline_ptxas': base_ptxas} \
        if base is not None else {}
    if host is not None:
        extra['host_baseline'] = host
    emit(phase, shapes=rows, timer='cuda events', rates=rates,
         int_ops_per_cell=INT_OPS_PER_CELL, **extra)
    return main


@contextlib.contextmanager
def env_set(**env):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cli(main, argv, platform, stdout_path=None, **env):
    """One of the port's CLIs in this process; returns (seconds, the
    structured log events it wrote to stderr).  With ``stdout_path`` its
    standard output goes to that file."""
    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        stack.enter_context(env_set(SWIFTORTHO_PLATFORM=platform, **env))
        stack.enter_context(contextlib.redirect_stderr(buf))
        if stdout_path is not None:
            out = stack.enter_context(open(stdout_path, 'w'))
            stack.enter_context(contextlib.redirect_stdout(out))
        t0 = time.time()
        rc = main(argv)
        seconds = time.time() - t0
    check(rc == 0, '%s exited %s' % (argv[0], rc))
    return seconds, events_of(buf.getvalue())


def events_of(stderr_text):
    return [json.loads(ln.split(' ', 1)[1]) for ln in
            stderr_text.splitlines() if ln.startswith('[swiftortho] {')]


def run_find_hit(fsa, out, platform, *flags, **env):
    from swiftortho_tpu_torch.cli.find_hit import main
    return run_cli(main, ['find_hit', '-p', 'blastp', '-i', fsa, '-d', fsa,
                          '-o', out, *flags], platform, **env)


DEVICE_ROUTES = {'SWIFTORTHO_INDEX': 'device',
                 'SWIFTORTHO_CANDIDATES': 'device',
                 'SWIFTORTHO_DEVICE_PACK': 'force'}
FALLBACKS = ('device_index_fallback', 'device_candidates_fallback')


def route_pairs(events):
    """(packed, host-gathered) pairs over a search's waves."""
    waves = [e for e in events if e['stage'] == 'search_wave']
    return (sum(w['packed_pairs'] for w in waves),
            sum(w['gathered_pairs'] for w in waves))


def stage_split(events):
    """Summed seconds per stage of the device index and engine."""
    out = {}
    for e in events:
        if e['stage'] in ('device_index', 'device_candidates'):
            pre = 'index_' if e['stage'] == 'device_index' else 'cand_'
            for k, v in e.items():
                if k.endswith('_s'):
                    out[pre + k] = round(out.get(pre + k, 0.0) + v, 4)
    return out


def write_corpus_checked(tmp, name, spec, want_md5):
    from swiftortho_tpu_torch.corpus import make_corpus, write_corpus
    fsa = os.path.join(tmp, name)
    corpus = make_corpus(**spec)
    write_corpus(fsa, corpus)
    got = md5(fsa)
    check(got == want_md5,
          'numpy made a different corpus for make_corpus(%s): md5 %s, '
          'expected %s' % (spec, got, want_md5))
    return fsa, len(corpus.records)


def phase_search_parity(tmp):
    fsa, n = write_corpus_checked(tmp, 'small.fsa', SMALL, SMALL_FSA_MD5)
    out = {}
    secs = {}
    for plat in ('cuda', 'cpu'):
        out[plat] = os.path.join(tmp, 'small.%s.sc' % plat)
        secs[plat], _ = run_find_hit(fsa, out[plat], plat)
    with open(out['cuda'], 'rb') as f:
        a = f.read()
    with open(out['cpu'], 'rb') as f:
        b = f.read()
    check(a == b, 'cuda and cpu .sc differ')
    check(md5(out['cuda']) == SMALL_SC_MD5,
          '.sc md5 %s != the JAX package\'s %s'
          % (md5(out['cuda']), SMALL_SC_MD5))
    emit('search_parity', sequences=n, rows=a.count(b'\n'),
         sc_md5=md5(out['cuda']), identical=True,
         cuda_s=round(secs['cuda'], 3), cpu_s=round(secs['cpu'], 3))


def phase_device_search_parity(tmp, torch):
    """The device routes on SMALL on cuda: each alone, all three, a
    partial pair table (hot-set pick) and a posting cap that cuts stage 2
    into >= 4 row blocks; every .sc md5 equal to the JAX package's.
    Returns the launches of the x-drop walk and accept-rounds kernels."""
    from swiftortho_tpu_torch.io_fasta import SeqDB
    from swiftortho_tpu_torch.ops import accept_rounds_cuda as ar
    from swiftortho_tpu_torch.ops import xdrop_walk_cuda as xw
    from swiftortho_tpu_torch.ops.device_pack import DevicePackContext
    fsa = os.path.join(tmp, 'small.fsa')
    check(md5(fsa) == SMALL_FSA_MD5, 'small.fsa missing or changed')
    db = SeqDB.from_path(fsa)
    stride = DevicePackContext(db, torch.device('cuda')).stride
    runs = [(k, {k: v}) for k, v in DEVICE_ROUTES.items()]
    runs += [('all', dict(DEVICE_ROUTES)),
             ('pack_half_table', {'SWIFTORTHO_DEVICE_PACK': 'force',
                                  'SWIFTORTHO_PACK_CAP':
                                      str(len(db) // 2 * stride)})]
    rows, postings = [], None
    t_phase = time.time()
    xw.reset_counters()
    ar.reset_counters()
    for name, env in runs + [('cand_row_blocks', None)]:
        if env is None:
            # cap: at most a fifth of the wave's postings (>= 5 blocks),
            # at least the largest query's (no host fallback)
            check(postings is not None, 'no device_candidates event')
            cap = max(postings[1], postings[0] // 5)
            env = {'SWIFTORTHO_CANDIDATES': 'device',
                   'SWIFTORTHO_DEVICE_CAND_CAP': str(cap)}
        out = os.path.join(tmp, 'small.%s.sc' % name)
        secs, events = run_find_hit(fsa, out, 'cuda', **env)
        got = md5(out)
        check(got == SMALL_SC_MD5, '%s: .sc md5 %s != the JAX package\'s %s'
              % (name, got, SMALL_SC_MD5))
        check(not [e for e in events if e['stage'] in FALLBACKS],
              '%s: a device route fell back to the host' % name)
        packed, gathered = route_pairs(events)
        cands = [e for e in events if e['stage'] == 'device_candidates']
        row = {'run': name, 'env': env, 'sc_md5': got,
               'seconds': round(secs, 3), 'packed_pairs': packed,
               'gathered_pairs': gathered}
        if env.get('SWIFTORTHO_DEVICE_PACK') == 'force':
            check(packed > 0, '%s: no pair was packed' % name)
        if name == 'pack_half_table':
            check(gathered > 0, '%s: no pair took the host gather' % name)
        if name == 'SWIFTORTHO_CANDIDATES':
            postings = (sum(e['postings'] for e in cands),
                        max(e['max_row_postings'] for e in cands))
        if name == 'cand_row_blocks':
            chunked = [e for e in events
                       if e['stage'] == 'device_candidates_chunked']
            check(chunked and min(e['blocks'] for e in chunked) >= 4,
                  'posting cap %s gave no >= 4-block stage 2: %s'
                  % (env['SWIFTORTHO_DEVICE_CAND_CAP'], chunked))
            row['blocks'] = [e['blocks'] for e in chunked]
        rows.append(row)
    check(xw.launches > 0 and xw.launches == 2 * ar.launches,
          'the device candidate routes launched the x-drop walk kernel %d '
          'and the accept-rounds kernel %d times (two walks and one accept '
          'a row block)' % (xw.launches, ar.launches))
    emit('device_search_parity', sequences=len(db), runs=rows,
         xdrop_walk_launches=xw.launches, accept_rounds_launches=ar.launches,
         seconds=round(time.time() - t_phase, 3))
    return xw.launches, ar.launches


def phase_search(tmp, torch):
    from swiftortho_tpu_torch.ops import banded_sw_cuda as cu
    fsa, n = write_corpus_checked(tmp, 'big.fsa', BIG, BIG_FSA_MD5)
    out = os.path.join(tmp, 'big.sc')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cu.reset_counters()
    wall, events = run_find_hit(fsa, out, 'cuda')
    launches = dict(cu.launches)
    aligned = dict(cu.pairs)
    shapes = {k: dict(v) for k, v in cu.shapes.items()}
    peak = torch.cuda.max_memory_allocated()
    got = md5(out)
    check(got == BIG_SC_MD5, '.sc md5 %s != the JAX package\'s %s'
          % (got, BIG_SC_MD5))
    check(launches['full'] > 0 and launches['score_only'] > 0,
          'kernel variants not launched by the search: %s' % launches)
    waves = [e for e in events if e['stage'] == 'search_wave']
    pa = [e for e in events if e['stage'] == 'search_phaseA']
    check(waves and pa, 'search logged no waves or no phase A')
    with open(out, 'rb') as f:
        rows = sum(1 for _ in f)
    res = dict(sequences=n, rows=rows, sc_md5=got,
               wall_s=round(wall, 3), index_s=pa[0]['idx_wait_s'],
               phaseA_s=pa[0]['cand_s'],
               align_s=round(sum(w['align1_s'] for w in waves), 3),
               policy_s=round(sum(w['policy_s'] for w in waves), 3),
               waves=len(waves),
               candidate_pairs=sum(w['pairs'] for w in waves),
               pairs_aligned=aligned, launches=launches,
               launch_shapes=shapes, peak_device_bytes=peak)
    emit('search', **res)
    return res


@contextlib.contextmanager
def recording(cd, name, key, store):
    """Record in ``store``, under ``key(args)``, the arguments of the first
    call of the engine's function ``name`` for each key, cloned, while the
    calls run as they would: ``walk`` by step (the first row block's right
    and left walks), ``accept`` once (the first row block's)."""
    real = getattr(cd, name)

    def call(*args):
        k = key(args)
        if k not in store:
            store[k] = tuple(a.clone() if hasattr(a, 'clone') else a
                             for a in args)
        return real(*args)
    setattr(cd, name, call)
    try:
        yield
    finally:
        setattr(cd, name, real)


def phase_device_components(tmp, np, torch):
    """On the 41k corpus: the cuda index of the first chunk against the
    host build_index (its tensors on the card, then its fetched arrays),
    and the device engine on the first 4,096-query wave against the host
    engine (twice: cold, then warm; no host fetch of the index), with
    stage times and the launches of the x-drop walk kernel (two a row
    block) and of the accept-rounds kernel (one a row block).  Returns
    the arguments of the cold run's first right and left walks, by step,
    and of its first accept rounds, and the launches of both kernels."""
    from swiftortho_tpu_torch.config import SearchConfig
    from swiftortho_tpu_torch.io_fasta import SeqDB
    from swiftortho_tpu_torch.ops import accept_rounds_cuda as ar
    from swiftortho_tpu_torch.ops import xdrop_walk_cuda as xw
    from swiftortho_tpu_torch.ops.index import build_index
    from swiftortho_tpu_torch.ops.index_device import build_index_device
    from swiftortho_tpu_torch.search import candidates_device as cd
    from swiftortho_tpu_torch.search.blastp import _mask_queries
    from swiftortho_tpu_torch.search.candidates import generate_candidates
    cuda = torch.device('cuda')
    fsa = os.path.join(tmp, 'big.fsa')
    check(md5(fsa) == BIG_FSA_MD5, 'big.fsa missing or changed')
    db = SeqDB.from_path(fsa)
    cfg = SearchConfig()
    alphabets = cfg.resolved_alphabets()
    args = (db, 0, min(cfg.effective_chunk(), len(db)), alphabets, cfg.seeds,
            cfg.nc, cfg.step)
    t0 = time.time()
    host = build_index(*args, threshold_override=cfg.threshold)
    host_index_s = time.time() - t0
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.time()
    with contextlib.redirect_stderr(buf):
        dev = build_index_device(*args, threshold_override=cfg.threshold,
                                 device=cuda)
    device_index_s = time.time() - t0
    # the index stays on the card: its tensors against the host arrays,
    # uploaded, with no host fetch of its own
    check(dev.device.type == 'cuda' and not dev._host,
          'device index not left on the card: %s, fetched %s'
          % (dev.device, sorted(dev._host)))
    for f in ('start', 'locus', 'sid', 'sst'):
        t = dev.tensors[f]
        check(torch.equal(t, torch.from_numpy(getattr(host, f))
                          .to(t.device, t.dtype)),
              'device index tensor %s != host build_index' % f)
    check(np.array_equal(host.soas, dev.soas), 'device index soas differs')
    check(host.threshold == dev.threshold, 'device index threshold %s != %s'
          % (dev.threshold, host.threshold))
    idx_ev = events_of(buf.getvalue())[-1]

    maxq = int(db.lengths.max())
    pad = max(64, 1 << max(0, (maxq - 1).bit_length()))
    nq = min(cfg.query_batch, len(db))
    toks, lens = _mask_queries(db, np.arange(nq, dtype=np.int64), pad, True)
    t0 = time.time()
    want = generate_candidates(toks, lens, db, host, alphabets, cfg.seeds)
    host_cand_s = time.time() - t0
    runs, walks, accepts = [], {}, {}
    xw.reset_counters()
    ar.reset_counters()
    for rep in range(2):
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.time()
        with contextlib.ExitStack() as stack:
            stack.enter_context(contextlib.redirect_stderr(buf))
            if rep == 0:
                stack.enter_context(recording(cd, 'walk', lambda a: a[10],
                                              walks))
                stack.enter_context(recording(cd, 'accept',
                                              lambda a: 'accept', accepts))
            got = cd.generate_candidates_device(toks, lens, db, dev,
                                                alphabets, cfg.seeds,
                                                device=cuda)
        secs = time.time() - t0
        for f in ('qrow', 'subject', 'score', 'band_q', 'band_s'):
            check(np.array_equal(getattr(got, f), getattr(want, f)),
                  'device candidates %s != host generate_candidates' % f)
        ev = [e for e in events_of(buf.getvalue())
              if e['stage'] == 'device_candidates']
        check(ev, 'no device_candidates event (fell back?)')
        runs.append({'seconds': round(secs, 4),
                     **{k: v for k, v in ev[0].items()
                        if k not in ('ts', 'stage', 'device')}})
    check(not dev._host, 'the device engine fetched the device index\'s '
          '%s to the host' % sorted(dev._host))
    check(all(a is dev.tensors[k] for a, k in zip(
        cd._device_index(dev, cuda), ('start', 'sid', 'sst'))),
        'the device engine does not use the device index\'s tensors')
    for f in ('start', 'locus', 'sid', 'sst'):
        check(np.array_equal(getattr(host, f), getattr(dev, f)),
              'device index %s, fetched, != host build_index' % f)
    walk_launches = {'launches': xw.launches, 'points': xw.points}
    accept_launches = {'launches': ar.launches, 'points': ar.points}
    blocks = sum(r['blocks'] for r in runs)
    check(walk_launches['launches'] == 2 * blocks,
          'x-drop walk kernel launched %s times for %d row blocks (two '
          'walks a block)' % (walk_launches, blocks))
    check(accept_launches['launches'] == blocks,
          'accept-rounds kernel launched %s times for %d row blocks (one '
          'a block)' % (accept_launches, blocks))
    emit('device_components', sequences=len(db), index_T=idx_ev['T'],
         postings=idx_ev['postings'], threshold=dev.threshold,
         index_equal=True, index_on_card=True, engine_host_fetches=0,
         host_index_s=round(host_index_s, 4),
         device_index_s=round(device_index_s, 4),
         device_index_stages={k: v for k, v in idx_ev.items()
                              if k.endswith('_s')},
         wave=[nq, pad], candidates=len(want.subject), candidates_equal=True,
         host_candidates_s=round(host_cand_s, 4), device_candidates=runs,
         xdrop_walk=walk_launches, accept_rounds=accept_launches)
    return (walks, accepts['accept'], walk_launches['launches'],
            accept_launches['launches'])


def walk_edge_points(np, torch, step, device):
    """Edge points of one direction on the card: a query as wide as its
    row, subjects identical to it (walks that run to the end of their
    sequence), shorter and unrelated; a group's first point at 0, bounds
    at 0 and at the lengths, base > 0, starts past the end, junk bytes.
    Returns (qtok_flat, db_tokens, L, per-point tensors by name) on
    ``device``."""
    L = 64
    rng = np.random.default_rng(5)
    AA = np.frombuffer(b'ACDEFGHIKLMNPQRSTVWY', np.uint8)
    q = AA[rng.integers(0, 20, (3, L))]
    q[2, ::3] = np.frombuffer(b'xX*J-a', np.uint8)[rng.integers(0, 6, 22)]
    subs = [q[0], q[1, :40], AA[rng.integers(0, 20, 50)], q[2, :L - 5]]
    offs = np.concatenate([[0], np.cumsum([len(x) for x in subs])])
    NEG = -(1 << 30)
    pts = []                # qrow, sid, start_q, start_s, base, qlo, slo, qlen
    for qrow, sid in ((0, 0), (1, 1), (0, 2), (2, 3), (1, 0)):
        qlen = L if qrow == 0 else 47
        for start in (0, 1, 20, qlen - 1, qlen):
            for base in (0, 25):
                pts.append((qrow, sid, start, start, base, -1, NEG, qlen))
                pts.append((qrow, sid, start, start, base, 0, 0, qlen))
                pts.append((qrow, sid, start, start + 3, base, 4, 1, qlen))
    a = np.array(pts, np.int64)
    if step == -1:
        a[:, 6] = np.maximum(a[:, 6], -1)
    i32 = {k: torch.from_numpy(a[:, c].astype(np.int32)).to(device)
           for c, k in ((0, 'qrow'), (2, 'start_q'), (3, 'start_s'),
                        (4, 'base'), (5, 'qlo'), (6, 'slo'), (7, 'qlen'))}
    i32['slen'] = torch.from_numpy(
        np.diff(offs)[a[:, 1]].astype(np.int32)).to(device)
    i32['s_off'] = torch.from_numpy(offs[a[:, 1]]).to(device)
    return (torch.from_numpy(q.reshape(-1)).to(device),
            torch.from_numpy(np.concatenate(subs)).to(device), L, i32)


def union_len(torch, lo, hi):
    """Positions covered by the union of the closed ranges [lo, hi]."""
    if lo.numel() == 0:
        return 0
    order = torch.argsort(lo)
    lo, hi = lo[order], hi[order]
    reach = torch.cummax(hi, 0).values
    reach = torch.cat([reach.new_full((1,), -1), reach[:-1]])
    return int((hi - torch.maximum(lo, reach + 1) + 1).clamp(min=0).sum())


def walk_work(torch, step, L, qrow, s_off, start_q, start_s, steps):
    """(steps walked, token bytes read once): the query and subject
    positions the walks read, each counted once."""
    n = steps.long()
    on = n > 0
    n = n[on]
    first = -(n - 1) if step == -1 else torch.zeros_like(n)
    q_lo = qrow[on].long() * L + start_q[on].long() + first
    s_lo = s_off[on] + start_s[on].long() + first
    return (int(n.sum()), union_len(torch, q_lo, q_lo + n - 1)
            + union_len(torch, s_lo, s_lo + n - 1))


def phase_walk_parity(np, torch, walks, rates):
    """The x-drop walk kernel against walk_chunked on the card, bit for
    bit: both directions of one real row block of the 41k corpus (the
    arguments recorded in device_components) and edge points, with the
    cap Wmax below the walks' length too.  Then both timed with CUDA
    events in turns (plain, kernel, kernel, plain), beside the bound:
    the larger of WALK_OPS_PER_STEP per step walked over the ALU rate
    and WALK_POINT_BYTES a point plus the token bytes read once over the
    memory rate.  Returns the kernel's row for the kernels line."""
    from swiftortho_tpu_torch.ops import xdrop_walk_cuda as xw
    from swiftortho_tpu_torch.search import candidates_device as cd
    check(sorted(walks) == [-1, 1], 'device_components recorded the walks '
          '%s, not both directions' % sorted(walks))
    t_phase = time.time()
    rows, max_err, edges = [], 0, 0

    def compare(name, args):
        (qtok, db, _, L, WC, Wmax, qrow, s_off, sq, ss, step, base, qlo,
         slo, qlen, slen) = args
        best, best_t, steps = xw.xdrop_walk_cuda(
            qtok, db, L, Wmax, qrow, s_off, sq, ss, step, base, qlo, slo,
            qlen, slen, steps=True)
        want, want_t = cd.walk_chunked(*args)
        bad = int(((best != want) | (best_t != want_t)).sum())
        check(bad == 0, '%s: the x-drop walk kernel differs from '
              'walk_chunked at %d of %d points' % (name, bad, len(want)))
        err = max(int((best - want).abs().max()),
                  int((best_t - want_t).abs().max())) if len(want) else 0
        return steps, err

    for step in (1, -1):
        qtok, db, L, t = walk_edge_points(np, torch, step,
                                          walks[1][0].device)
        b62 = cd.scoring_tables(qtok.device)['sub_flat']
        for wmax, wc in ((L + 1, cd.WALK_CHUNK), (8, 8), (8, 1)):
            args = (qtok, db, b62, L, wc, wmax, t['qrow'], t['s_off'],
                    t['start_q'], t['start_s'], step, t['base'], t['qlo'],
                    t['slo'], t['qlen'], t['slen'])
            steps, err = compare('edge points, step %d, Wmax %d'
                                 % (step, wmax), args)
            max_err = max(max_err, err)
            edges += len(steps)
            if wmax == 8:
                check(int(steps.max()) == 8, 'edge points: no walk met the '
                      'cap Wmax = 8')
        empty = args[:6] + tuple(x[:0] for x in args[6:10]) + (step,) \
            + tuple(x[:0] for x in args[11:])
        steps, _ = compare('no points', empty)
        check(steps.shape == (0,), 'no points gave %s' % (steps.shape,))

    total = {'ops': 0, 'bytes': 0}
    for step, name in ((1, 'right'), (-1, 'left')):
        args = walks[step]
        (qtok, db, _, L, WC, Wmax, qrow, s_off, sq, ss, _, base, qlo, slo,
         qlen, slen) = args
        steps, err = compare('41k block, %s walk' % name, args)
        max_err = max(max_err, err)
        walked, token_bytes = walk_work(torch, step, L, qrow, s_off, sq, ss,
                                        steps)
        P = qrow.shape[0]
        fns = {'plain': (lambda: cd.walk_chunked(*args), 1),
               'kernel': (lambda: xw.xdrop_walk_cuda(
                   qtok, db, L, Wmax, qrow, s_off, sq, ss, step, base, qlo,
                   slo, qlen, slen), 20)}
        samples = {k: [] for k in fns}
        for _ in range(2):
            for k in ('plain', 'kernel', 'kernel', 'plain'):
                fn, n = fns[k]
                samples[k].append(timed_ms(torch, fn, n))
        ms = {k: sorted(v)[len(v) // 2] for k, v in samples.items()}
        ops = WALK_OPS_PER_STEP * walked
        nbytes = WALK_POINT_BYTES * P + token_bytes
        total['ops'] += ops
        total['bytes'] += nbytes
        ops_ms = ops / rates['int_ops_per_s'] * 1e3
        bytes_ms = nbytes / rates['bytes_per_s'] * 1e3
        rows.append({'walk': name, 'step': step, 'points': P, 'L': L,
                     'steps': walked, 'mean_steps': walked / max(P, 1),
                     'max_steps': int(steps.max()) if P else 0,
                     'token_bytes': token_bytes, 'mismatches': 0,
                     'ms': ms['kernel'], 'plain_ms': ms['plain'],
                     'bound_ms': max(ops_ms, bytes_ms),
                     'bound_by': 'operations' if ops_ms >= bytes_ms
                     else 'bytes',
                     'bound_share': max(ops_ms, bytes_ms) / ms['kernel'],
                     'speedup': ms['plain'] / ms['kernel'],
                     'samples_ms': samples})
    ops_ms = total['ops'] / rates['int_ops_per_s'] * 1e3
    bytes_ms = total['bytes'] / rates['bytes_per_s'] * 1e3
    main = {'ms': sum(r['ms'] for r in rows),
            'plain_ms': sum(r['plain_ms'] for r in rows),
            'bound_ms': max(ops_ms, bytes_ms),
            'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
            'max_abs_err': max_err,
            'shape': {r['walk'] + '_points': r['points'] for r in rows}}
    emit('walk_parity', tolerance=0, mismatches=0, max_abs_err=max_err,
         edge_points=edges, blocks=rows, timer='cuda events',
         ops_per_step=WALK_OPS_PER_STEP, point_bytes=WALK_POINT_BYTES,
         rates=rates, both_walks=main,
         seconds=round(time.time() - t_phase, 3))
    return main


def accept_edge_cases(torch, device):
    """The accept rounds' edge inputs of ``ops/accept_rounds_cases.py``
    (those the CPU tests hold the plain version to) at 40 times the
    tests' scale, as tensors on ``device`` by name."""
    from swiftortho_tpu_torch.ops.accept_rounds_cases import (CASES,
                                                              make_case)
    return {name: tuple(torch.from_numpy(x).to(device)
                        for x in make_case(name, seed=11, scale=40))
            for name in CASES}


def phase_accept_parity(np, torch, block, rates):
    """The accept-rounds kernel against the plain accept_rounds on the
    card, bit for bit (acc, qlo_rec, rounds): the first stage-2 row block
    of the 41k wave (the arguments recorded in device_components) and
    edge inputs.  The engine's ``accept`` runs under
    ``torch.cuda.set_sync_debug_mode('error')``, so a host read inside it
    fails the run.  Then both timed with CUDA events in turns (plain,
    kernel, kernel, plain), beside the bound: the larger of the block's
    least bytes (ACCEPT_POINT_BYTES a point, ACCEPT_VALID_BYTES a valid
    point, ACCEPT_ACCEPTED_BYTES an accepted one, and the round count)
    over the memory rate and ACCEPT_OPS_PER_POINT a point over the ALU
    rate.  Returns the kernel's row for the kernels line."""
    from swiftortho_tpu_torch.ops import accept_rounds_cuda as ar
    from swiftortho_tpu_torch.search import candidates_device as cd
    t_phase = time.time()
    cases = accept_edge_cases(torch, block[0].device)
    cases['41k_block'] = block
    rows, max_err = [], 0
    for name, args in cases.items():
        want = cd.accept_rounds(*args)
        before = ar.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            acc, qlo, rounds = cd.accept(*args)
        finally:
            torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()
        C = args[0].shape[0]
        check(ar.launches == before + (C > 0), '%s: %d accept-rounds '
              'launches for %d points' % (name, ar.launches - before, C))
        bad = int(((acc != want[0]) | (qlo != want[1])).sum())
        check(bad == 0 and int(rounds) == want[2],
              '%s: the accept-rounds kernel differs from accept_rounds at '
              '%d of %d points, rounds %d against %d'
              % (name, bad, C, int(rounds), want[2]))
        if C:
            max_err = max(max_err, int((qlo - want[1]).abs().max()),
                          int((acc != want[0]).sum()),
                          abs(int(rounds) - want[2]))
        starts = args[0].nonzero().squeeze(1)
        seg_len = torch.diff(torch.cat([starts, starts.new_full((1,), C)]))
        rows.append({'case': name, 'points': C,
                     'segments': int(starts.numel()),
                     'longest_segment': int(seg_len.max()) if C else 0,
                     'accepted': int(want[0].sum()), 'rounds': want[2],
                     'mismatches': 0})

    C = block[0].shape[0]
    fns = {'plain': (lambda: cd.accept_rounds(*block), 1),
           'kernel': (lambda: ar.accept_rounds_cuda(*block), 20)}
    samples = {k: [] for k in fns}
    for _ in range(2):
        for k in ('plain', 'kernel', 'kernel', 'plain'):
            fn, n = fns[k]
            samples[k].append(timed_ms(torch, fn, n))
    ms = {k: sorted(v)[len(v) // 2] for k, v in samples.items()}
    n_valid, n_acc = int(block[1].sum()), rows[-1]['accepted']
    nbytes = (ACCEPT_POINT_BYTES * C + ACCEPT_VALID_BYTES * n_valid
              + ACCEPT_ACCEPTED_BYTES * n_acc + 4)
    ops_ms = ACCEPT_OPS_PER_POINT * C / rates['int_ops_per_s'] * 1e3
    bytes_ms = nbytes / rates['bytes_per_s'] * 1e3
    main = {'ms': ms['kernel'], 'plain_ms': ms['plain'],
            'bound_ms': max(ops_ms, bytes_ms),
            'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
            'max_abs_err': max_err,
            'shape': {'points': C, 'valid': n_valid, 'accepted': n_acc}}
    emit('accept_parity', tolerance=0, mismatches=0,
         sync_debug_mode='error', cases=rows, timer='cuda events',
         samples_ms=samples, bytes=nbytes, point_bytes=ACCEPT_POINT_BYTES,
         valid_bytes=ACCEPT_VALID_BYTES,
         accepted_bytes=ACCEPT_ACCEPTED_BYTES,
         ops_per_point=ACCEPT_OPS_PER_POINT, rates=rates,
         bound_share=main['bound_ms'] / ms['kernel'],
         speedup=ms['plain'] / ms['kernel'], **main,
         seconds=round(time.time() - t_phase, 3))
    return main


WAVE_SPLIT = ('rank_s', 'prep_s', 'run_s', 'pack_s', 'sw_s',
              'postprocess_s', 'policy_s', 'format_s', 'emit_s')


def phase_search_device(tmp, torch, default):
    """The 41k search with the three device routes: the .sc md5, no
    fallback, every pair packed on the card and both kernel variants
    launched through the packed route, the x-drop walk kernel launched
    twice a stage-2 row block (the right and the left walk) and the
    accept-rounds kernel once, the device wave's split summed over the
    waves (host seconds by part; ``pack_s`` and ``sw_s`` device seconds)
    and each wave's host reads; beside the default route.  Returns the SW
    launches, their shapes and the walk and accept kernels' launches."""
    from swiftortho_tpu_torch.ops import accept_rounds_cuda as ar
    from swiftortho_tpu_torch.ops import banded_sw_cuda as cu
    from swiftortho_tpu_torch.ops import device_pack
    from swiftortho_tpu_torch.ops import xdrop_walk_cuda as xw
    fsa = os.path.join(tmp, 'big.fsa')
    out = os.path.join(tmp, 'big.device.sc')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cu.reset_counters()
    xw.reset_counters()
    ar.reset_counters()
    device_pack.reset_prof()
    wall, events = run_find_hit(fsa, out, 'cuda', **DEVICE_ROUTES)
    launches = dict(cu.launches)
    walk = {'launches': xw.launches, 'points': xw.points}
    accept = {'launches': ar.launches, 'points': ar.points}
    aligned = dict(cu.pairs)
    shapes = {k: dict(v) for k, v in cu.shapes.items()}
    packed_calls = dict(device_pack.PROF['calls'])
    peak = torch.cuda.max_memory_allocated()
    got = md5(out)
    check(got == BIG_SC_MD5, 'device route: .sc md5 %s != the JAX '
          'package\'s %s' % (got, BIG_SC_MD5))
    fb = [e for e in events if e['stage'] in FALLBACKS]
    check(not fb, 'device route fell back to the host: %s' % fb[:3])
    packed, gathered = route_pairs(events)
    check(packed > 0 and gathered == 0,
          'pairs packed %d, host-gathered %d' % (packed, gathered))
    check(launches['full'] > 0 and launches['score_only'] > 0
          and packed_calls == launches,
          'kernel launches %s, of them through the packed route %s'
          % (launches, packed_calls))
    blocks = sum(e['blocks'] for e in events
                 if e['stage'] == 'device_candidates')
    check(blocks > 0 and walk['launches'] == 2 * blocks,
          'x-drop walk kernel launched %s times for %d stage-2 row blocks'
          % (walk, blocks))
    check(accept['launches'] == blocks,
          'accept-rounds kernel launched %s times for %d stage-2 row blocks'
          % (accept, blocks))
    waves = [e for e in events if e['stage'] == 'search_wave']
    pa = [e for e in events if e['stage'] == 'search_phaseA']
    check(waves and pa, 'search logged no waves or no phase A')
    # the device wave ran every wave: its split and host reads
    split = [e for e in events if e['stage'] == 'device_wave']
    check(len(split) == len(waves)
          and all('host_syncs' in w for w in waves),
          'device wave: %d split events and host_syncs in %d of %d waves'
          % (len(split), sum('host_syncs' in w for w in waves), len(waves)))
    res = dict(sc_md5=got, wall_s=round(wall, 3),
               index_s=pa[0]['idx_wait_s'], phaseA_s=pa[0]['cand_s'],
               align_s=round(sum(w['align1_s'] for w in waves), 3),
               policy_s=round(sum(w['policy_s'] for w in waves), 3),
               waves=len(waves), packed_pairs=packed,
               gathered_pairs=gathered,
               pack_s=round(device_pack.PROF['pack_s'], 4),
               packed_align_s=round(device_pack.PROF['align_s'], 4),
               wave_split={k: round(sum(e[k] for e in split), 4)
                           for k in WAVE_SPLIT},
               host_syncs=[w['host_syncs'] for w in waves],
               esc_rounds=[w['esc_rounds'] for w in waves],
               stages=stage_split(events), pairs_aligned=aligned,
               launches=launches, launch_shapes=shapes, xdrop_walk=walk,
               accept_rounds=accept, stage2_blocks=blocks,
               peak_device_bytes=peak)
    emit('search_device', **res,
         default_route={k: default[k] for k in
                        ('wall_s', 'index_s', 'phaseA_s', 'align_s',
                         'policy_s', 'launches', 'peak_device_bytes')})
    return launches, shapes, walk['launches'], accept['launches']


def profiled(torch, fn):
    """Run fn() under torch.profiler; returns (its result, the device
    time by kernel).  Kernel time counts only CUDA kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.time() - t0
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    total_us = sum(us for _, us in rows)
    if not total_us:
        return out, {'kernel_time': 'not measured (no CUDA events)'}
    rows.sort(key=lambda r: -r[1])
    return out, {'wall_s': round(wall, 4),
                 'kernel_s': round(total_us / 1e6, 4),
                 'busy_share': round(total_us / 1e6 / wall, 4),
                 'top': [{'kernel': k[:90], 'ms': round(us / 1e3, 3),
                          'share': round(us / total_us, 4)}
                         for k, us in rows[:8]]}


def phase_orth(tmp):
    from swiftortho_tpu_torch.cli.find_orth import main
    sc = os.path.join(tmp, 'big.sc')
    opc = os.path.join(tmp, 'big.opc')
    secs, _ = run_cli(main, ['find_orth', '-i', sc], 'cuda', opc)
    got = md5(opc)
    check(got == BIG_OPC_MD5, '.opc md5 %s != the JAX package\'s %s'
          % (got, BIG_OPC_MD5))
    with open(opc, 'rb') as f:
        rows = sum(1 for _ in f)
    emit('orth', rows=rows, opc_md5=got, seconds=round(secs, 3))
    return opc


def phase_cluster_parity(tmp, opc, torch):
    """find_cluster on the 41k orthology graph: every md5 equal to the
    JAX package's; the device modes run twice (the second under the
    profiler) and must write the same bytes."""
    from swiftortho_tpu_torch.cli.find_cluster import main
    from swiftortho_tpu_torch.native import load as load_native
    cases = [('mcl', 'cuda', 'mcl', {}), ('mcl', 'cpu', 'mcl', {}),
             ('apc_textbook', 'cuda', 'apc', {'SWIFTORTHO_APC_FAITHFUL': '0'}),
             ('sap', 'cuda', 'sap', {}),
             ('apc_faithful', 'cuda', 'apc', {})]
    t_phase = time.time()
    rows = []
    for name, plat, algo, env in cases:
        argv = ['find_cluster', '-i', opc, '-a', algo]
        out = os.path.join(tmp, 'big.%s.%s.clsr' % (name, plat))
        secs, events = run_cli(main, argv, plat, out, **env)
        got = md5(out)
        check(got == BIG_CLSR_MD5[name],
              '%s on %s: .clsr md5 %s != the JAX package\'s %s'
              % (name, plat, got, BIG_CLSR_MD5[name]))
        with open(out, 'rb') as f:
            groups = sum(1 for _ in f)
        row = {'case': name, 'platform': plat, 'groups': groups,
               'md5': got, 'seconds': round(secs, 3)}
        dense = [e for e in events if e['stage'] == 'mcl_dense_batch']
        if dense:
            row['dense_batches'] = len(dense)
            row['dense_device_s'] = round(sum(e['device_s'] for e in dense), 4)
            row['dense_host_s'] = round(sum(e['build_s'] + e['extract_s']
                                            for e in dense), 4)
            row['max_iterations'] = max(e['iterations'] for e in dense)
        if name == 'apc_faithful':
            load_native()
            check(not [e for e in events if e['stage'] == 'fallback'],
                  'faithful apc ran the pure-Python fallback')
            row['native'] = True
        elif plat == 'cuda':
            again = out + '.again'
            _, prof = profiled(torch, lambda: run_cli(main, argv, plat,
                                                      again, **env))
            with open(out, 'rb') as f, open(again, 'rb') as g:
                check(f.read() == g.read(),
                      '%s: two cuda runs wrote different bytes' % name)
            row['repeat_identical'] = True
            row['profile'] = prof
        rows.append(row)
    emit('cluster_parity', cases=rows, seconds=round(time.time() - t_phase, 3))


def clique_chain(np, rng, n_cliques, base=0, bridge_w=0.05):
    """n_cliques cliques of CLIQUE nodes in a chain joined by weak
    bridges: ONE component whose MCL partition is the cliques."""
    a, b = np.triu_indices(CLIQUE, 1)
    off = base + CLIQUE * np.arange(n_cliques)[:, None]
    ei = (off + a).ravel()
    ej = (off + b).ravel()
    w = 1.0 + 0.1 * rng.random(len(ei))
    bi = base + CLIQUE * np.arange(1, n_cliques)
    return (np.concatenate([ei, bi - 1]), np.concatenate([ej, bi]),
            np.concatenate([w, np.full(len(bi), bridge_w)]))


def partition(np, m, ri, rj):
    from swiftortho_tpu_torch.cluster.components import connected_components
    labels = connected_components(m, ri, rj)
    present = np.zeros(m, bool)
    present[ri] = True
    present[rj] = True
    return sorted(tuple(np.flatnonzero((labels == lab) & present).tolist())
                  for lab in np.unique(labels[present]))


def phase_cluster_scale(np, torch):
    import scipy.sparse as sp
    from swiftortho_tpu_torch.cluster import mcl as port_mcl
    from swiftortho_tpu_torch.cluster.mcl_blocksparse import mcl_blocksparse
    cuda = torch.device('cuda')
    t_phase = time.time()
    rng = np.random.default_rng(42)

    # >= 1.0M edges: planted family cliques (dense batches) + one chain
    # of cliques over max_dense nodes (block-sparse)
    t0 = time.time()
    a, b = np.triu_indices(CLIQUE, 1)
    off = CLIQUE * np.arange(SCALE_FAMILIES)[:, None]
    fi, fj = (off + a).ravel(), (off + b).ravel()
    fw = 1.0 + 0.1 * rng.random(len(fi))
    base = SCALE_FAMILIES * CLIQUE
    ci, cj, cw = clique_chain(np, rng, SCALE_CHAIN, base=base)
    ei, ej, w = (np.concatenate(x) for x in ((fi, ci), (fj, cj), (fw, cw)))
    n = base + SCALE_CHAIN * CLIQUE
    check(len(ei) >= SCALE_MIN_EDGES, 'scale graph has %d edges' % len(ei))
    build_s = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(buf):
        clusters = port_mcl.mcl_cluster(n, ei, ej, w, device=cuda)
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    events = events_of(buf.getvalue())
    check(len(clusters) == SCALE_FAMILIES + SCALE_CHAIN
          and all(len(c) == CLIQUE and c[0] % CLIQUE == 0
                  and c[-1] == c[0] + CLIQUE - 1 for c in clusters),
          'million-edge partition != the planted families')
    dense = [e for e in events if e['stage'] == 'mcl_dense_batch']
    bs = [e for e in events if e['stage'] == 'mcl_blocksparse']
    dense_it = sum(e['iterations'] for e in dense)
    dense_dev = sum(e['device_s'] for e in dense)
    million = {
        'nodes': n, 'edges': len(ei), 'clusters': len(clusters),
        'graph_build_s': round(build_s, 3), 'seconds': round(secs, 3),
        'dense_batches': [{k: e[k] for k in ('s', 'batch', 'iterations',
                                              'build_s', 'device_s',
                                              'extract_s')} for e in dense],
        'dense_ms_per_iteration': round(1e3 * dense_dev / dense_it, 3),
        'blocksparse': [{k: e[k] for k in ('m', 'iterations', 'seconds',
                                            'max_tiles', 'max_pairs')}
                        for e in bs],
        'peak_device_bytes': peak}

    # one 20,480-node component through the block-sparse engine, twice,
    # against the scipy oracle
    m = BIG_COMPONENT_CLIQUES * CLIQUE
    li, lj, lw = clique_chain(np, rng, BIG_COMPONENT_CLIQUES)
    lw = lw.astype(np.float32)
    selfw = np.zeros(m, np.float32)
    np.maximum.at(selfw, li, lw)
    np.maximum.at(selfw, lj, lw)
    runs = []
    for rep in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.time()

        def engine():
            with contextlib.redirect_stderr(buf):
                return mcl_blocksparse(m, li, lj, lw, selfw, 1.5,
                                       mb=BIG_COMPONENT_MB, device=cuda)
        if rep == 0:
            got, prof = engine(), None
        else:
            got, prof = profiled(torch, engine)
        ev = events_of(buf.getvalue())[-1]
        runs.append({'got': got, 'seconds': time.time() - t0, 'event': ev,
                     'peak': torch.cuda.max_memory_allocated(),
                     'profile': prof})
    check(all(np.array_equal(p, q) for p, q in zip(runs[0]['got'],
                                                   runs[1]['got'])),
          'two block-sparse runs left different entries')
    t0 = time.time()
    mat = sp.lil_matrix((m, m), dtype=np.float32)
    mat[li, lj] = lw
    mat[lj, li] = lw
    mat.setdiag(selfw)
    xr = port_mcl._mcl_sparse(mat, 1.5)
    oracle_s = time.time() - t0
    want = partition(np, m, *(xr > 1e-5).nonzero())
    got = partition(np, m, *runs[0]['got'])
    check(got == want, 'block-sparse partition != the scipy oracle\'s')
    check(len(got) == BIG_COMPONENT_CLIQUES,
          'block-sparse found %d clusters, planted %d'
          % (len(got), BIG_COMPONENT_CLIQUES))
    ev = runs[0]['event']
    component = {
        'nodes': m, 'edges': len(li), 'mb': BIG_COMPONENT_MB,
        'clusters': len(got), 'iterations': ev['iterations'],
        'max_tiles': ev['max_tiles'], 'max_pairs': ev['max_pairs'],
        'seconds': [round(r['seconds'], 3) for r in runs],
        'ms_per_iteration': round(1e3 * runs[0]['seconds']
                                  / ev['iterations'], 3),
        'iterations_per_s': round(ev['iterations'] / runs[0]['seconds'], 3),
        'peak_device_bytes': [r['peak'] for r in runs],
        'repeat_identical': True, 'scipy_oracle_s': round(oracle_s, 3),
        'profile': runs[1]['profile']}
    emit('cluster_scale', million_edge=million, oversize_component=component,
         seconds=round(time.time() - t_phase, 3))


FLEET_CHILD = r"""
import json, sys, time
sys.modules['jax'] = None
sys.modules['swiftortho_tpu'] = None
from swiftortho_tpu_torch.cli.find_hit import main
from swiftortho_tpu_torch.ops import banded_sw_cuda as cu
cu.reset_counters()
t0 = time.time()
rc = main(['find_hit', '-p', 'blastp', '-i', sys.argv[1], '-d', sys.argv[1],
           '-o', sys.argv[2]])
print(json.dumps({'rc': rc, 'seconds': time.time() - t0,
                  'launches': cu.launches, 'pairs': cu.pairs}))
"""


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_fleet(tmp):
    """find_hit on the 41k corpus as a FLEET_RANKS-rank fleet on the card:
    the merged .sc, each rank's half of the queries, SW launches in each
    rank's every wave, no part file left.  Returns (the result row, the
    launches summed over the ranks)."""
    import glob
    from swiftortho_tpu_torch.parallel.distributed import rank_query_range
    fsa = os.path.join(tmp, 'big.fsa')
    check(md5(fsa) == BIG_FSA_MD5, 'big.fsa missing or changed')
    fdir = os.path.join(tmp, 'fleet')
    os.makedirs(fdir)
    out = os.path.join(fdir, 'big.sc')
    env = dict(os.environ, SWIFTORTHO_PLATFORM='cuda',
               SWIFTORTHO_COORD='127.0.0.1:%d' % free_port(),
               SWIFTORTHO_NPROCS=str(FLEET_RANKS),
               SWIFTORTHO_DIST_TIMEOUT=str(FLEET_TIMEOUT))
    ranks, t0 = [], time.time()
    try:
        for r in range(FLEET_RANKS):
            files = [open(os.path.join(fdir, 'rank%d.%s' % (r, x)), 'w')
                     for x in ('out', 'err')]
            ranks.append((subprocess.Popen(
                [sys.executable, '-c', FLEET_CHILD, fsa, out],
                env=dict(env, SWIFTORTHO_PROC_ID=str(r)), stdout=files[0],
                stderr=files[1],
                cwd=os.path.dirname(os.path.abspath(__file__))), files))
        for proc, _ in ranks:
            proc.wait(timeout=max(1.0, FLEET_TIMEOUT - (time.time() - t0)))
    finally:
        for proc, files in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for f in files:
                f.close()
    wall = time.time() - t0
    n = sum(1 for ln in open(fsa) if ln.startswith('>'))
    rows, launches = [], {'full': 0, 'score_only': 0}
    for r, (proc, files) in enumerate(ranks):
        with open(files[0].name) as f:
            lines = f.read().splitlines()
        with open(files[1].name) as f:
            err = f.read()
        check(proc.returncode == 0 and lines,
              'fleet rank %d exited %s: %s' % (r, proc.returncode,
                                               err[-3000:]))
        res = json.loads(lines[-1])
        check(res['rc'] == 0, 'fleet rank %d returned %s' % (r, res['rc']))
        ev = events_of(err)
        span = [(e['q_lo'], e['q_hi']) for e in ev
                if e['stage'] == 'fleet_rank_range']
        check(span == [rank_query_range(0, n, FLEET_RANKS, r)],
              'fleet rank %d searched %s' % (r, span))
        waves = [e for e in ev if e['stage'] == 'search_wave']
        check(waves and all(sum(w['sw_launches'].values()) > 0
                            for w in waves),
              'fleet rank %d: a wave without SW launches' % r)
        check(res['launches']['full'] > 0
              and res['launches']['score_only'] > 0,
              'fleet rank %d launched %s' % (r, res['launches']))
        for k in launches:
            launches[k] += res['launches'][k]
        ph = [e for e in ev if e['stage'] == 'fleet_rank_phases']
        check(len(ph) == 1, 'fleet rank %d logged no phases' % r)
        rows.append({'rank': r, 'queries': list(span[0]),
                     'waves': len(waves), 'launches': res['launches'],
                     'pairs': res['pairs'],
                     'process_s': round(res['seconds'], 3),
                     **{k: ph[0][k] for k in ('search_s', 'barrier_s',
                                              'merge_s', 'total_s')}})
    got = md5(out)
    check(got == BIG_SC_MD5, 'fleet: .sc md5 %s != the JAX package\'s %s'
          % (got, BIG_SC_MD5))
    left = glob.glob(out + '.part*')
    check(not left, 'fleet left part files: %s' % left)
    return {'ranks': rows, 'sequences': n, 'sc_md5': got,
            'wall_s': round(wall, 3)}, launches


def run_mesh_search(tmp, torch):
    """blastp_sharded on SMALL over a mesh of the card's devices (gather
    and pack routes) and over the card repeated as a (2, 2) mesh (pack):
    the .sc md5 each time, every pair packed on the pack route.  Returns
    (the rows, the launches summed over the runs)."""
    from swiftortho_tpu_torch.config import SearchConfig
    from swiftortho_tpu_torch.io_fasta import SeqDB
    from swiftortho_tpu_torch.ops import banded_sw_cuda as cu
    from swiftortho_tpu_torch.parallel.distributed import local_devices
    from swiftortho_tpu_torch.parallel.mesh import blastp_sharded, make_mesh
    fsa = os.path.join(tmp, 'small.fsa')
    check(md5(fsa) == SMALL_FSA_MD5, 'small.fsa missing or changed')
    db = SeqDB.from_path(fsa)
    cards = local_devices(torch.device('cuda'))
    pack = {'SWIFTORTHO_DEVICE_PACK': 'force'}
    runs = [('cards', make_mesh(devices=cards), {}),
            ('cards_pack', make_mesh(devices=cards), pack),
            ('card_2x2_pack', make_mesh(n_data=2, n_db=2,
                                        devices=[cards[0]] * 4), pack)]
    rows, launches = [], {'full': 0, 'score_only': 0}
    for name, mesh, env in runs:
        out = os.path.join(tmp, 'small.mesh_%s.sc' % name)
        buf = io.StringIO()
        cu.reset_counters()
        t0 = time.time()
        with env_set(SWIFTORTHO_PLATFORM='cuda', **env), \
                contextlib.redirect_stderr(buf), open(out, 'w') as fh:
            for row in blastp_sharded(db, db, SearchConfig(), mesh=mesh,
                                      device=torch.device('cuda')):
                fh.write(row)
        secs = time.time() - t0
        ran = dict(cu.launches)
        got = md5(out)
        check(got == SMALL_SC_MD5, 'mesh %s: .sc md5 %s != the JAX '
              'package\'s %s' % (name, got, SMALL_SC_MD5))
        check(ran['full'] > 0 and ran['score_only'] > 0,
              'mesh %s launched %s' % (name, ran))
        packed, gathered = route_pairs(events_of(buf.getvalue()))
        if env:
            check(packed > 0 and gathered == 0, 'mesh %s: packed %d, '
                  'host-gathered %d' % (name, packed, gathered))
        for k in launches:
            launches[k] += ran[k]
        rows.append({'run': name, 'mesh': list(mesh.shape),
                     'devices': [str(d) for d in mesh.flat()],
                     'sc_md5': got, 'seconds': round(secs, 3),
                     'packed_pairs': packed, 'gathered_pairs': gathered,
                     'launches': ran})
    return rows, launches


def run_multidb(tmp):
    """find_hit on SMALL with the reference cut into MULTIDB_CHUNK-sequence
    chunks, on the host route and under SWIFTORTHO_CANDIDATES=multidb:
    the same bytes, no shard falling back to the host engine."""
    fsa = os.path.join(tmp, 'small.fsa')
    from swiftortho_tpu_torch.cli.find_hit import main
    res = {}
    for name, env in (('host', {}),
                      ('multidb', {'SWIFTORTHO_CANDIDATES': 'multidb'})):
        out = os.path.join(tmp, 'small.c%d.%s.sc' % (MULTIDB_CHUNK, name))
        secs, ev = run_cli(main, ['find_hit', '-p', 'blastp', '-i', fsa,
                                  '-d', fsa, '-o', out, '-c',
                                  str(MULTIDB_CHUNK)], 'cuda', **env)
        pa = [e for e in ev if e['stage'] == 'search_phaseA']
        res[name] = {'sc_md5': md5(out), 'seconds': round(secs, 3),
                     'fallbacks': len([e for e in ev if e['stage']
                                       == 'device_candidates_fallback']),
                     'phaseA': {k: v for k, v in pa[0].items()
                                if k not in ('ts', 'stage')}}
    with open(os.path.join(tmp, 'small.c%d.host.sc' % MULTIDB_CHUNK),
              'rb') as f, open(os.path.join(
                  tmp, 'small.c%d.multidb.sc' % MULTIDB_CHUNK), 'rb') as g:
        check(f.read() == g.read(), 'multidb rows != the host route\'s')
    check(res['multidb']['phaseA'].get('mode') == 'multidb'
          and res['multidb']['phaseA']['shards_resident'] >= 4,
          'multidb ran %s' % res['multidb']['phaseA'])
    check(res['multidb']['fallbacks'] == 0,
          'a multidb shard fell back to the host engine')
    return dict(res, chunk=MULTIDB_CHUNK)


def run_demo_and_seg(tmp, np, torch):
    """demo_multichip on the card's mesh and on the card repeated as a
    (2, 2) mesh, each against the same step on the CPU; seg of SMALL's
    queries on the card against the CPU.  Returns (the row, launches)."""
    from swiftortho_tpu_torch.io_fasta import SeqDB
    from swiftortho_tpu_torch.ops import banded_sw_cuda as cu
    from swiftortho_tpu_torch.ops.seg import seg_batch
    from swiftortho_tpu_torch.parallel.distributed import local_devices
    from swiftortho_tpu_torch.parallel.mesh import demo_multichip, make_mesh
    cards = local_devices(torch.device('cuda'))
    cpu = torch.device('cpu')
    rows = []
    cu.reset_counters()
    for name, shape, devs in (('cards', None, cards),
                              ('card_2x2', (2, 2), [cards[0]] * 4)):
        kw = {} if shape is None else {'n_data': 2, 'n_db': 2}
        got = demo_multichip(mesh=make_mesh(devices=devs, **kw))
        want = demo_multichip(mesh=make_mesh(devices=[cpu] * len(devs),
                                             **kw))
        for k, g, w in zip(('masked', 'bits', 'merged'), got, want):
            check(g.dtype == w.dtype and np.array_equal(g, w),
                  'demo_multichip %s on the card != the CPU' % k)
        masked, bits, merged = got
        top = np.full(len(merged), -1, np.int64)
        np.maximum.at(top, np.arange(len(bits)) % len(merged),
                      bits.astype(np.int64))
        check(np.array_equal(merged.astype(np.int64), top),
              'demo_multichip merged != the per-query max of bits')
        rows.append({'mesh': name, 'queries': len(merged),
                     'pairs': len(bits), 'masked_equal_cpu': True})
    launches = dict(cu.launches)
    check(launches['full'] > 0, 'demo_multichip launched %s' % launches)
    db = SeqDB.from_path(os.path.join(tmp, 'small.fsa'))
    toks, lens = db.padded_batch(np.arange(len(db), dtype=np.int64),
                                 int(db.lengths.max()))
    # low-complexity openings (a window's entropy is taken against the
    # first window's counts) and lowercase residues in a third of the rows
    toks[::6, :40] = ord('A')
    toks[3::6, :36] = np.frombuffer(b'QP' * 18, np.uint8)
    toks[1::6] = np.where(toks[1::6] >= 65, toks[1::6] + 32, 0)
    t0 = time.time()
    on_card = seg_batch(torch.from_numpy(toks).cuda(),
                        torch.from_numpy(lens).cuda()).cpu().numpy()
    card_s = time.time() - t0
    on_cpu = seg_batch(torch.from_numpy(toks), torch.from_numpy(lens)).numpy()
    check(np.array_equal(on_card, on_cpu), 'seg_batch on the card != CPU')
    masked = int((on_cpu == ord('x')).sum())
    check(masked > 0, 'seg_batch masked nothing')
    return {'demo': rows, 'seg': {'queries': len(db),
                                  'width': int(toks.shape[1]),
                                  'masked_residues': masked,
                                  'card_s': round(card_s, 3),
                                  'equal_cpu': True}}, launches


def run_mcl_mesh(tmp, opc, np, torch):
    """find_cluster -a mcl under SWIFTORTHO_MCL_MESH=1 on the 41k graph
    (the .clsr md5), and the sharded block-sparse expansion over the card
    repeated 2 and 4 times against one device, by partition."""
    from swiftortho_tpu_torch.cli.find_cluster import main
    from swiftortho_tpu_torch.cluster.mcl_blocksparse import mcl_blocksparse
    from swiftortho_tpu_torch.parallel.mesh import make_mesh
    out = os.path.join(tmp, 'big.mcl_mesh.clsr')
    secs, _ = run_cli(main, ['find_cluster', '-i', opc, '-a', 'mcl'], 'cuda',
                      out, SWIFTORTHO_MCL_MESH='1')
    got = md5(out)
    check(got == BIG_CLSR_MD5['mcl'], 'SWIFTORTHO_MCL_MESH: .clsr md5 %s '
          '!= the JAX package\'s %s' % (got, BIG_CLSR_MD5['mcl']))
    cuda = torch.device('cuda')
    rng = np.random.default_rng(7)
    m = MESH_COMPONENT_CLIQUES * CLIQUE
    li, lj, lw = clique_chain(np, rng, MESH_COMPONENT_CLIQUES)
    lw = lw.astype(np.float32)
    selfw = np.zeros(m, np.float32)
    np.maximum.at(selfw, li, lw)
    np.maximum.at(selfw, lj, lw)
    runs = []
    for ndev in (1, 2, 4):
        mesh = make_mesh(n_data=ndev, devices=[cuda] * ndev) \
            if ndev > 1 else None
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stderr(buf):
            ri, rj = mcl_blocksparse(m, li, lj, lw, selfw, 1.5,
                                     mb=MESH_COMPONENT_MB, device=cuda,
                                     mesh=mesh)
        ev = events_of(buf.getvalue())[-1]
        check(ev['devices'] == ndev, 'sharded expansion ran on %s devices, '
              'not %d' % (ev['devices'], ndev))
        runs.append({'devices': ndev, 'seconds': round(time.time() - t0, 3),
                     'iterations': ev['iterations'],
                     'partition': partition(np, m, ri, rj)})
    check(all(r['partition'] == runs[0]['partition'] for r in runs),
          'sharded expansion partitions != the one-device run\'s')
    check(len(runs[0]['partition']) == MESH_COMPONENT_CLIQUES,
          'sharded expansion found %d clusters, planted %d'
          % (len(runs[0]['partition']), MESH_COMPONENT_CLIQUES))
    return {'find_cluster': {'clsr_md5': got, 'seconds': round(secs, 3)},
            'blocksparse': {'nodes': m, 'mb': MESH_COMPONENT_MB,
                            'runs': [{k: v for k, v in r.items()
                                      if k != 'partition'} for r in runs]}}


def phase_multichip(tmp, opc, np, torch):
    """The multi-device and multi-process paths on the one card; returns
    the kernel launches of the fleet and of the mesh routes."""
    t_phase = time.time()
    fleet, fleet_launches = run_fleet(tmp)
    mesh, mesh_launches = run_mesh_search(tmp, torch)
    demo, demo_launches = run_demo_and_seg(tmp, np, torch)
    for k in mesh_launches:
        mesh_launches[k] += demo_launches[k]
    multidb = run_multidb(tmp)
    mcl = run_mcl_mesh(tmp, opc, np, torch)
    emit('multichip', fleet=fleet, mesh_search=mesh, multidb=multidb,
         **demo, mcl_mesh=mcl, launches={'fleet': fleet_launches,
                                         'mesh': mesh_launches},
         seconds=round(time.time() - t_phase, 3))
    return {'fleet': fleet_launches, 'mesh': mesh_launches}


PIPELINE_CHILD = r"""
import json, os, sys, time
sys.modules['jax'] = None
sys.modules['swiftortho_tpu'] = None
os.environ['SWIFTORTHO_PLATFORM'] = 'cuda'
from swiftortho_tpu_torch.cli.run_all import main
from swiftortho_tpu_torch.ops import banded_sw_cuda as cu
cu.reset_counters()
t0 = time.time()
rc = main(['run_all', '-i', sys.argv[1], '-A', 'mcl'])
print(json.dumps({'rc': rc, 'seconds': time.time() - t0,
                  'launches': cu.launches, 'pairs': cu.pairs}))
"""


def start_pipeline(tmp):
    """run_all -A mcl on SMALL in a child process (its stage 5 is host
    Python that would otherwise hold the script for minutes), with
    SWIFTORTHO_TRACE_DIR set: its orth and cluster stages write
    torch.profiler traces."""
    pdir = os.path.join(tmp, 'pipeline')
    os.makedirs(pdir)
    fsa, n = write_corpus_checked(pdir, 'small.fsa', SMALL, SMALL_FSA_MD5)
    trace = os.path.join(pdir, 'trace')
    child = start_child(tmp, 'pipeline', [sys.executable, '-c',
                                          PIPELINE_CHILD, fsa],
                        SWIFTORTHO_TRACE_DIR=trace)
    return dict(child, fsa=fsa, n=n, trace=trace)


def trace_summary(path, top=8):
    """One stage's Chrome trace (the ``*.pt.trace.json`` files under
    ``path``): its event count, CUDA kernel launches and the device
    operations (kernels, copies, sets) by summed duration."""
    import glob
    files = glob.glob(os.path.join(path, '*.pt.trace.json'))
    check(files, 'no trace file under %s' % path)
    by_name, n_events, kernels = {}, 0, 0
    for f in files:
        with open(f) as fh:
            events = json.load(fh)['traceEvents']
        n_events += len(events)
        for e in events:
            if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset'):
                kernels += e['cat'] == 'kernel'
                by_name[e['name']] = by_name.get(e['name'], 0.0) + e['dur']
    total_us = sum(by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {'files': len(files), 'bytes': sum(os.path.getsize(f)
                                              for f in files),
            'events': n_events, 'kernel_launches': kernels,
            'device_ms': total_us / 1e3,
            'top': [{'op': k[:90], 'ms': us / 1e3,
                     'share': us / total_us} for k, us in rows]}


def check_pan(pan_path, clsr_path, fsa):
    """The .pan against the port's copy of the JAX package's stage-4 code
    on the same .clsr here, and against the pinned digest outside the curve-fit
    lines; returns what was compared."""
    import scipy
    from swiftortho_tpu_torch.analysis.pan_genome import pan_report
    from swiftortho_tpu_torch.io_fasta import SeqDB
    ref = io.StringIO()
    with open(clsr_path) as fh:
        pan_report(SeqDB.from_path(fsa), fh, ref, ts=0.05, tc=0.95)
    with open(pan_path, encoding='utf-8') as f:
        pan = f.read()
    check(pan == ref.getvalue(),
          '.pan != pan_report (the port\'s copy) on the same .clsr')
    nofit = ''.join(ln for ln in pan.splitlines(True) if '±' not in ln)
    got = hashlib.md5(nofit.encode()).hexdigest()
    check(got == PAN_NOFIT_MD5, '.pan outside its curve-fit lines: md5 %s '
          '!= the JAX package\'s %s' % (got, PAN_NOFIT_MD5))
    return {'md5': md5(pan_path), 'md5_jax_scipy_1_17': PAN_MD5,
            'nofit_md5': got, 'equals_pan_report_here': True,
            'fit_lines': len(pan.splitlines()) - len(nofit.splitlines()),
            'scipy': scipy.__version__}


def phase_pipeline(pipe):
    from swiftortho_tpu_torch.analysis.exttools import find_tool
    proc = pipe['proc']
    t_wait = time.time()
    proc.wait(timeout=900)
    waited = time.time() - t_wait
    for f in pipe['files']:
        f.flush()
    stdout_path, stderr_path = (f.name for f in pipe['files'])
    with open(stdout_path) as f:
        lines = f.read().splitlines()
    with open(stderr_path) as f:
        err = f.read()
    check(proc.returncode == 0 and lines,
          'run_all child exited %s: %s' % (proc.returncode, err[-2000:]))
    res = json.loads(lines[-1])
    check(res['rc'] == 0, 'run_all returned %s' % res['rc'])
    check(res['launches']['full'] > 0 and res['launches']['score_only'] > 0,
          'run_all did not launch both kernel variants: %s'
          % res['launches'])
    base = pipe['fsa'] + '_results/small.fsa.'
    md5s = {ext: md5(base + ext) for ext in PIPE_MD5}
    bad = {ext: got for ext, got in md5s.items() if got != PIPE_MD5[ext]}
    check(not bad, 'run_all outputs differ from the JAX package\'s: %s'
          % bad)
    pan = check_pan(base + 'pan', base + 'clsr', pipe['fsa'])
    gaps = [e for e in events_of(err) if e['stage'] == 'trace_unavailable']
    check(not gaps, 'run_all: a stage trace did not start: %s' % gaps)
    traces = {st: trace_summary(os.path.join(pipe['trace'], st))
              for st in ('orth', 'cluster')}
    check(traces['cluster']['kernel_launches'] > 0,
          'the cluster stage\'s trace names no CUDA kernel: %s'
          % traces['cluster'])
    stages = {ln.rsplit(':', 1)[0]: float(ln.rsplit(':', 1)[1])
              for ln in lines[:-1] if ln.endswith(tuple('0123456789'))
              and ' time:' in ln}
    nwk = base + 'nwk'
    tools = {t: find_tool(t) is not None
             for t in ('famsa', 'mafft', 'muscle', 'trimal', 'fasttree',
                       'FastTree')}
    emit('pipeline', sequences=pipe['n'], md5=md5s, pan=pan, traces=traces,
         nwk_md5=md5(nwk) if os.path.exists(nwk) else None,
         nwk_md5_jax_without_tools=PIPE_NWK_MD5_NO_TOOLS,
         tools_on_path=tools, launches=res['launches'], pairs=res['pairs'],
         run_all_s=round(res['seconds'], 3), stage_s=stages,
         seconds=round(time.time() - pipe['t0'], 3),
         waited_s=round(waited, 3),
         ran_beside='search_parity, device_search_parity, search, '
                    'device_components, search_device, orth, '
                    'cluster_parity, cluster_scale, multichip, multichunk, '
                    'long_pairs, scale, kernel_time_paths')


def search_summary(events, wall):
    """Chunks, waves, blocks, residency and stage seconds of one search
    from its log events."""
    waves = [e for e in events if e['stage'] == 'search_wave']
    pa = [e for e in events if e['stage'] == 'search_phaseA']
    check(waves and len(pa) == 1, 'search logged no waves or no phase A')
    pa = pa[0]
    packed, gathered = route_pairs(events)
    return {'wall_s': round(wall, 3), 'chunks': pa['chunks'],
            'waves': len(waves), 'blocks': pa.get('blocks'),
            'max_resident_indexes': pa.get('max_resident_indexes'),
            'prefetch': pa.get('prefetch'), 'index_s': pa['idx_wait_s'],
            'phaseA_s': pa['cand_s'],
            'align_s': round(sum(w['align1_s'] for w in waves), 3),
            'policy_s': round(sum(w['policy_s'] for w in waves), 3),
            'packed_pairs': packed, 'gathered_pairs': gathered,
            'long_pairs': sum(w['long_pairs'] for w in waves),
            'long_tiles': sum(w['long_tiles'] for w in waves)}


def add_launches(total, shapes, cu):
    """Add the wrapper's counts since its last reset to ``total`` and
    ``shapes``."""
    for var in total:
        total[var] += cu.launches[var]
        for key, (n, pairs, bmax) in cu.shapes[var].items():
            row = shapes[var].setdefault(key, [0, 0, 0])
            row[0] += n
            row[1] += pairs
            row[2] = max(row[2], bmax)


def phase_multichunk(tmp, torch):
    """The 41k corpus at -c 10000 (five reference chunks): the default
    route; makedb then -D with strict streaming (no prefetch), blocks of
    two waves and a candidate spill (-T) that must end empty; and the
    three device routes.  Every .sc equals the JAX package's for -c
    10000.  Returns (the SW launches of the three searches, their shapes,
    the device routes' walk and accept-rounds launches)."""
    import shutil
    from swiftortho_tpu_torch.cli.find_hit import main as find_hit
    from swiftortho_tpu_torch.ops import accept_rounds_cuda as ar
    from swiftortho_tpu_torch.ops import banded_sw_cuda as cu
    from swiftortho_tpu_torch.ops import device_pack
    from swiftortho_tpu_torch.ops import xdrop_walk_cuda as xw
    fsa = os.path.join(tmp, 'big.fsa')
    check(md5(fsa) == BIG_FSA_MD5, 'big.fsa missing or changed')
    mdir = os.path.join(tmp, 'multichunk')
    os.makedirs(mdir)
    flags = ('-c', str(MULTICHUNK))
    launches = {'full': 0, 'score_only': 0}
    shapes = {'full': {}, 'score_only': {}}
    t_phase = time.time()
    runs = []

    def search(name, *extra, **env):
        out = os.path.join(mdir, name + '.sc')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cu.reset_counters()
        device_pack.reset_prof()
        wall, events = run_find_hit(fsa, out, 'cuda', *flags, *extra, **env)
        ran = dict(cu.launches)
        add_launches(launches, shapes, cu)
        got = md5(out)
        check(got == BIG_C10000_SC_MD5, 'multichunk %s: .sc md5 %s != the '
              'JAX package\'s %s' % (name, got, BIG_C10000_SC_MD5))
        check(ran['full'] > 0 and ran['score_only'] > 0,
              'multichunk %s launched %s' % (name, ran))
        row = {'run': name, 'env': env, 'flags': list(flags + extra),
               'sc_md5': got, **search_summary(events, wall),
               'launches': ran, 'pairs_aligned': dict(cu.pairs),
               'peak_device_bytes': torch.cuda.max_memory_allocated()}
        check(row['chunks'] == MULTICHUNK_CHUNKS, 'multichunk %s: %d chunks'
              % (name, row['chunks']))
        runs.append(row)
        return row, events

    search('default')

    db = os.path.join(mdir, 'db.fsa')
    shutil.copy(fsa, db)
    makedb_s, _ = run_cli(find_hit, ['find_hit', '-p', 'makedb', '-i', db,
                                     *flags], 'cuda')
    spill = os.path.join(mdir, 'spill')
    row, _ = search('makedb_D_strict_block2_spill', '-D', db, '-T', spill,
                    SWIFTORTHO_PREFETCH_INDEX='0', SWIFTORTHO_WAVE_BLOCK='2')
    check(row['max_resident_indexes'] == 1 and not row['prefetch'],
          'strict streaming held %s indexes (prefetch %s)'
          % (row['max_resident_indexes'], row['prefetch']))
    check(row['blocks'] == -(-row['waves'] // 2), 'blocks of two waves: '
          '%s blocks for %s waves' % (row['blocks'], row['waves']))
    left = os.listdir(spill)
    check(left == [], 'the spill directory is not empty: %s' % left[:5])
    row['makedb_s'] = round(makedb_s, 3)
    row['index_files'] = len([f for f in os.listdir(mdir)
                              if f.startswith('db.fsa.')])
    for f in os.listdir(mdir):
        if f.startswith('db.fsa.'):
            os.remove(os.path.join(mdir, f))

    xw.reset_counters()
    ar.reset_counters()
    row, events = search('device_routes', **DEVICE_ROUTES)
    row['xdrop_walk_launches'] = walk_launches = xw.launches
    row['accept_rounds_launches'] = accept_launches = ar.launches
    check(walk_launches > 0 and walk_launches == 2 * accept_launches,
          'multichunk device routes launched the x-drop walk kernel %d and '
          'the accept-rounds kernel %d times (two walks and one accept a '
          'row block)' % (walk_launches, accept_launches))
    fb = [e for e in events if e['stage'] in FALLBACKS]
    check(not fb, 'multichunk device routes fell back: %s' % fb[:3])
    check(row['packed_pairs'] > 0 and row['gathered_pairs'] == 0
          and dict(device_pack.PROF['calls']) == row['launches'],
          'multichunk device routes: packed %d, gathered %d, launches %s, '
          'through the packed route %s'
          % (row['packed_pairs'], row['gathered_pairs'], row['launches'],
             dict(device_pack.PROF['calls'])))
    row['stages'] = stage_split(events)
    emit('multichunk', sequences=sum(1 for ln in open(fsa)
                                     if ln.startswith('>')),
         chunk=MULTICHUNK, sc_md5=BIG_C10000_SC_MD5, runs=runs,
         launches=launches, launch_shapes=shapes,
         seconds=round(time.time() - t_phase, 3))
    return launches, shapes, walk_launches, accept_launches


def wide_shapes(shapes, width=4096):
    """The launch shapes with a padded width >= ``width``."""
    return {var: {k: v for k, v in by.items()
                  if max(int(x) for x in k.split('x')) >= width}
            for var, by in shapes.items()}


def phase_long_pairs(tmp, torch):
    """find_hit on the long-protein corpus: the JAX package's .sc, pairs
    through the 4096-wide tile path, and kernel launches at width 4096.
    Returns (its launches, their shapes)."""
    from swiftortho_tpu_torch.ops import banded_sw_cuda as cu
    fsa, n = write_corpus_checked(tmp, 'long.fsa', LONG, LONG_FSA_MD5)
    out = os.path.join(tmp, 'long.sc')
    cu.reset_counters()
    wall, events = run_find_hit(fsa, out, 'cuda')
    launches = {'full': 0, 'score_only': 0}
    shapes = {'full': {}, 'score_only': {}}
    add_launches(launches, shapes, cu)
    got = md5(out)
    check(got == LONG_SC_MD5, 'long pairs: .sc md5 %s != the JAX '
          'package\'s %s' % (got, LONG_SC_MD5))
    res = search_summary(events, wall)
    check(res['long_pairs'] > 0 and res['long_tiles'] > res['long_pairs'],
          'no pair took the tile path: %d pairs, %d tiles'
          % (res['long_pairs'], res['long_tiles']))
    wide = wide_shapes(shapes)
    check(wide['full'], 'no launch at a width >= 4096: %s' % shapes)
    with open(out) as f:
        rows = f.read().splitlines()
    past = sum(max(int(x) for x in ln.split('\t')[6:10]) > 4096
               for ln in rows)
    lengths = [len(seq) for seq in
               ''.join(ln if not ln.startswith('>') else '\n'
                       for ln in open(fsa).read().splitlines()).split()]
    emit('long_pairs', sequences=n, longest=max(lengths),
         at_least_4096=sum(x >= 4096 for x in lengths), rows=len(rows),
         rows_past_4096=past, sc_md5=got, **res, launches=launches,
         launch_shapes=shapes, wide_launches=wide)
    return launches, shapes


SCALE_CHILD = r"""
import sys
sys.modules['jax'] = None
sys.modules['swiftortho_tpu'] = None
from swiftortho_tpu_torch.tools.run_scale import main
raise SystemExit(main(sys.argv[1:]))
"""


def phase_scale(tmp, size):
    """tools.run_scale in a child process on the card: its .sc, .opc and
    .clsr against the JAX package's run_scale.py with the same arguments,
    -L y byte-equal, every group family-pure, the counts of the JAX run.
    Returns its result line."""
    spec = SCALE[size]
    wdir = os.path.join(tmp, 'scale_' + size)
    os.makedirs(wdir)
    out_path, err_path = (os.path.join(wdir, 'run_scale.' + x)
                          for x in ('out', 'err'))
    env = dict(os.environ, SWIFTORTHO_PLATFORM='cuda')
    t0 = time.time()
    with open(out_path, 'w') as out, open(err_path, 'w') as err:
        proc = subprocess.Popen(
            [sys.executable, '-c', SCALE_CHILD, '--workdir', wdir]
            + spec['args'], stdout=out, stderr=err, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            proc.wait(timeout=spec['timeout'])
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.time() - t0
    with open(out_path) as f:
        lines = f.read().splitlines()
    with open(err_path) as f:
        err = f.read()
    check(proc.returncode == 0 and lines,
          'run_scale %s exited %s: %s' % (size, proc.returncode,
                                          err[-3000:]))
    res = json.loads(lines[-1])
    md5s = {ext: md5(os.path.join(wdir, 'c.' + ext))
            for ext in ('fsa', 'sc', 'opc', 'clsr')}
    bad = {ext: got for ext, got in md5s.items() if got != spec['md5'][ext]}
    check(not bad, 'run_scale %s: md5s differ from the JAX package\'s '
          'run_scale.py: %s' % (size, bad))
    bad = {k: res[k] for k, v in spec['counts'].items() if res[k] != v}
    check(not bad, 'run_scale %s: counts %s, the JAX run\'s %s'
          % (size, bad, spec['counts']))
    check(res['pure_groups'] == res['clsr_groups'] > 0,
          'run_scale %s: %d of %d groups family-pure'
          % (size, res['pure_groups'], res['clsr_groups']))
    if '--orth-out-of-core' in spec['args']:
        check(res.get('orth_out_of_core_equal') is True,
              'run_scale %s: find_orth -L y not checked' % size)
    kl = res['kernel']['launches']
    check(kl['full'] > 0 and kl['score_only'] > 0,
          'run_scale %s launched %s' % (size, kl))
    events = events_of(err)
    waves = [e for e in events if e['stage'] == 'search_wave']
    check(waves and all(sum(w['sw_launches'].values()) > 0 for w in waves),
          'run_scale %s: a wave without SW launches' % size)
    emit('scale', size=size, args=spec['args'], md5=md5s, result=res,
         published=spec.get('published'), process_s=round(wall, 3))
    return res


def start_child(tmp, name, argv, **env):
    """``argv`` in a child process from the repository root, its output
    into files under ``tmp/name`` (also its TMPDIR)."""
    wdir = os.path.join(tmp, name)
    os.makedirs(wdir, exist_ok=True)
    files = tuple(open(os.path.join(wdir, 'child.' + x), 'w')
                  for x in ('out', 'err'))
    proc = subprocess.Popen(
        argv, stdout=files[0], stderr=files[1],
        env=dict(os.environ, TMPDIR=wdir, **env),
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return {'name': name, 'proc': proc, 'files': files, 't0': time.time()}


def wait_child(child, timeout):
    """Wait for a start_child process (``timeout`` seconds from its
    start); it must exit 0.  Returns (its standard output lines, its
    seconds)."""
    proc = child['proc']
    try:
        proc.wait(timeout=max(1.0, timeout - (time.time() - child['t0'])))
    finally:
        stop_child(child)
    with open(child['files'][0].name) as f:
        lines = f.read().splitlines()
    with open(child['files'][1].name) as f:
        err = f.read()
    check(proc.returncode == 0 and lines, '%s exited %s: %s'
          % (child['name'], proc.returncode,
             (err or '\n'.join(lines))[-3000:]))
    return lines, time.time() - child['t0']


def stop_child(child):
    if child['proc'].poll() is None:
        child['proc'].kill()
        child['proc'].wait()
    for f in child['files']:
        f.close()


def start_example_run(tmp):
    """tools/example_run.sh in a child beside the search phases, with no
    SWIFTORTHO_PLATFORM: the script runs on the card by default."""
    path = os.pathsep.join([os.path.dirname(sys.executable),
                            os.environ.get('PATH', '')])
    return start_child(tmp, 'example_run', ['bash', os.path.join(
        'swiftortho_tpu_torch', 'tools', 'example_run.sh')], PATH=path)


def start_phasea_prep(tmp):
    """profile_phaseA --waves 0 in a child: writes the 102,844-sequence
    corpus and its index cache, which the timed run in ``tools`` reuses."""
    return start_child(tmp, 'phaseA_prep', [
        sys.executable, '-m', 'swiftortho_tpu_torch.tools.profile_phaseA',
        '--waves', '0', '--workdir', os.path.join(tmp, 'phaseA')])


def phase_tools(tmp, torch, example, prep):
    """The port's tools against the JAX package's: scaling_bench at 1, 2
    and 4 ranks on the card (the .sc of each fleet equal to the JAX CLI's,
    kernel launches in every rank), profile_phaseA at its defaults (the
    JAX tool's candidate counts), bench_device_cand (parity at each cap)
    and example_run.sh (rc 0, the JAX CLI's ref.sc).  Returns the kernel
    launches of the scaling fleets."""
    from swiftortho_tpu_torch.tools.bench_device_cand import bench
    t_phase = time.time()
    seconds = {}

    child = start_child(tmp, 'scaling', [
        sys.executable, '-m', 'swiftortho_tpu_torch.tools.scaling_bench',
        '--procs', ','.join(map(str, SCALING_PROCS))],
        SWIFTORTHO_PLATFORM='cuda')
    lines, seconds['scaling_bench'] = wait_child(child, 900)
    scaling = json.loads(lines[-1])
    check([r['procs'] for r in scaling['results']] == list(SCALING_PROCS),
          'scaling_bench ran %s' % scaling['results'])
    check(md5(scaling['fsa']) == SCALING_FSA_MD5,
          'scaling_bench corpus md5 %s != %s' % (md5(scaling['fsa']),
                                                 SCALING_FSA_MD5))
    check(scaling['sc_md5'] == SCALING_SC_MD5, 'scaling_bench .sc md5 %s '
          '!= the JAX find_hit CLI\'s %s' % (scaling['sc_md5'],
                                             SCALING_SC_MD5))
    launches = {'full': 0, 'score_only': 0}
    for r in scaling['results']:
        check(len(r['ranks']) == r['procs'] and r['cards'] >= 1,
              'scaling_bench %d ranks: %s' % (r['procs'], r))
        for rank in r['ranks']:
            check(rank['launches']['full'] > 0
                  and rank['launches']['score_only'] > 0,
                  'scaling_bench %d ranks: rank %d launched %s'
                  % (r['procs'], rank['rank'], rank['launches']))
            for k in launches:
                launches[k] += rank['launches'][k]

    lines, _ = wait_child(prep, 600)
    prep = json.loads(lines[-1])
    wdir = os.path.join(tmp, 'phaseA')
    check(md5(os.path.join(wdir, 'c.fsa')) == PHASEA_FSA_MD5,
          'profile_phaseA corpus md5 differs from the JAX tool\'s')
    child = start_child(tmp, 'phaseA', [
        sys.executable, '-m', 'swiftortho_tpu_torch.tools.profile_phaseA',
        '--workdir', wdir])
    lines, seconds['profile_phaseA'] = wait_child(child, 600)
    phase_a = json.loads(lines[-1])
    got = [w['cands'] for w in phase_a['waves']]
    check(phase_a['index_cached'] and got == PHASEA_CANDS,
          'profile_phaseA candidates per (wave, chunk) %s != the JAX '
          'tool\'s %s' % (got, PHASEA_CANDS))
    phase_a['prep'] = {k: prep[k] for k in ('corpus_s', 'index_s')}

    t0 = time.time()
    device_cand = bench(caps=DEVICE_CAND_CAPS, device=torch.device('cuda'),
                        out=io.StringIO())
    seconds['bench_device_cand'] = time.time() - t0
    check([c['cap'] for c in device_cand['caps']] == DEVICE_CAND_CAPS
          and all(c['parity'] for c in device_cand['caps']),
          'bench_device_cand: %s' % device_cand['caps'])

    lines, example_s = wait_child(example, 1050)
    sc = [ln.split()[-1] for ln in lines if ln.startswith('ref.sc md5 ')]
    check(sc == [EXAMPLE_SC_MD5] and lines[-1] == 'example_run: all stages OK',
          'example_run.sh: ref.sc md5 %s != the JAX CLI\'s %s, last line %r'
          % (sc, EXAMPLE_SC_MD5, lines[-1]))
    emit('tools', scaling_bench=scaling, profile_phaseA=phase_a,
         bench_device_cand=device_cand,
         example_run={'rc': 0, 'ref_sc_md5': sc[0], 'seconds': example_s,
                      'ran_beside': 'every phase before tools'},
         scaling_launches=launches, seconds=seconds,
         phase_s=time.time() - t_phase)
    return launches


def path_shapes(*shape_sets):
    """Per variant, the (B, L) of the most-used launch shape of each
    set (B = its pairs over its launches, L = the padded width less 12,
    as TIME_SHAPES reads it)."""
    out = {'full': [], 'score_only': []}
    for shapes in shape_sets:
        for var, by in shapes.items():
            if by:
                key, (n, pairs, _) = max(by.items(),
                                         key=lambda kv: kv[1][1])
                width = max(int(x) for x in key.split('x'))
                out[var].append((-(-pairs // n), width - 12))
    return {k: tuple(v) for k, v in out.items() if v}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--baseline', metavar='CU',
                    help='an earlier csrc/banded_sw.cu to time beside it')
    ap.add_argument('--scale', choices=('250k',),
                    help='run only the 252,608-sequence run_scale (after '
                         'the build, kernel parity and timing phases)')
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    dev, smi_line = phase_device(torch)
    phase_build()
    max_err = phase_kernel_parity(np, torch)
    times = phase_kernel_time(np, torch, args.baseline)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as tmp:
        if args.scale:
            res = phase_scale(tmp, args.scale)
            launches = res['kernel']['launches']
            by_route = {'scale_' + args.scale: launches}
            shapes_by_route = {'scale_' + args.scale:
                               res['kernel']['shapes']}
            phase_kernel_time(np, torch, shapes=path_shapes(
                res['kernel']['shapes']), phase='kernel_time_paths',
                rounds=1, plain_once=True)
        else:
            pipe = start_pipeline(tmp)
            children = [pipe, start_example_run(tmp)]
            try:
                phase_search_parity(tmp)
                walk_by_route, accept_by_route = {}, {}
                (walk_by_route['device_search_parity'],
                 accept_by_route['device_search_parity']) = \
                    phase_device_search_parity(tmp, torch)
                default = phase_search(tmp, torch)
                launches = default['launches']
                (walks, accept_block, walk_by_route['device_components'],
                 accept_by_route['device_components']) = \
                    phase_device_components(tmp, np, torch)
                rates = card_rates(torch)
                walk = phase_walk_parity(np, torch, walks, rates)
                accept = phase_accept_parity(np, torch, accept_block, rates)
                del walks, accept_block
                (packed, packed_shapes, walk['launches'],
                 accept['launches']) = phase_search_device(tmp, torch,
                                                           default)
                walk_by_route['device_routes'] = walk['launches']
                accept_by_route['device_routes'] = accept['launches']
                children.append(start_phasea_prep(tmp))
                opc = phase_orth(tmp)
                phase_cluster_parity(tmp, opc, torch)
                phase_cluster_scale(np, torch)
                multi = phase_multichip(tmp, opc, np, torch)
                (chunked, chunked_shapes, walk_by_route['multichunk'],
                 accept_by_route['multichunk']) = phase_multichunk(tmp,
                                                                   torch)
                long_launches, long_shapes = phase_long_pairs(tmp, torch)
                scale = phase_scale(tmp, '102k')
                # the long tiles are full-statistics launches at width 4096
                phase_kernel_time(np, torch, shapes=path_shapes(
                    scale['kernel']['shapes'],
                    {'full': wide_shapes(long_shapes)['full']}),
                    phase='kernel_time_paths', rounds=1, plain_once=True)
                phase_pipeline(pipe)
                tools = phase_tools(tmp, torch, *children[1:])
            finally:
                for child in children:
                    stop_child(child)
            by_route = {'host_gather': launches, 'device_pack': packed,
                        'fleet': multi['fleet'], 'mesh': multi['mesh'],
                        'multichunk': chunked, 'long_tiles': long_launches,
                        'scale': scale['kernel']['launches'],
                        'scaling_bench': tools}
            shapes_by_route = {'host_gather': default['launch_shapes'],
                               'device_pack': packed_shapes,
                               'multichunk': chunked_shapes,
                               'long_tiles': long_shapes,
                               'scale': scale['kernel']['shapes']}
    check(not [m for m in sys.modules
               if m.split('.')[0] in ('jax', 'swiftortho_tpu')
               and sys.modules[m] is not None],
          'jax or the JAX package was imported')
    kernels = [{'name': 'banded_sw_' + var, 'route': 'cuda',
                'source': SOURCE, 'replaces': REPLACES,
                'launches': launches[var],
                'launches_by_route': {r: n[var] for r, n in by_route.items()},
                'launch_shapes_by_route': {r: sh[var] for r, sh in
                                           shapes_by_route.items()},
                'max_abs_err': max_err[var],
                'ms': times[var]['ms'], 'plain_ms': times[var]['plain_ms'],
                'bound_ms': times[var]['bound_ms'],
                'bound_by': times[var]['bound_by'],
                'library_ms': None,
                'shape': [times[var]['B'], times[var]['L']]}
               for var in ('full', 'score_only')]
    if not args.scale:
        # the search's main path on the device routes is the 41k search
        kernels.append({'name': 'xdrop_walk', 'route': 'cuda',
                        'source': WALK_SOURCE, 'replaces': WALK_REPLACES,
                        'launches': walk['launches'],
                        'launches_by_route': walk_by_route,
                        'max_abs_err': walk['max_abs_err'],
                        'ms': walk['ms'], 'plain_ms': walk['plain_ms'],
                        'bound_ms': walk['bound_ms'],
                        'bound_by': walk['bound_by'], 'library_ms': None,
                        'shape': walk['shape']})
        kernels.append({'name': 'accept_rounds', 'route': 'cuda',
                        'source': ACCEPT_SOURCE, 'replaces': ACCEPT_REPLACES,
                        'launches': accept['launches'],
                        'launches_by_route': accept_by_route,
                        'max_abs_err': accept['max_abs_err'],
                        'ms': accept['ms'], 'plain_ms': accept['plain_ms'],
                        'bound_ms': accept['bound_ms'],
                        'bound_by': accept['bound_by'], 'library_ms': None,
                        'shape': accept['shape']})
    emit('done', seconds=round(time.time() - T_START, 1))
    print(smi_line)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': dev}), flush=True)


if __name__ == '__main__':
    main()
