#!/bin/bash
# Smoke run of the port mirroring the reference example/run.sh (whose
# ref.fsa corpus is a missing blob): generate a 5-proteome synthetic corpus
# with known ortholog families, run the 3-stage pipeline with both
# clusterings plus the full run_all, and assert non-trivial outputs.
# Counterpart of the JAX package's tools/example_run.sh, on the port's
# tools and CLIs.  It runs on the card unless the caller sets
# SWIFTORTHO_PLATFORM=cpu.
#
#   bash swiftortho_tpu_torch/tools/example_run.sh
set -e
cd "$(dirname "$0")/../.."
TMP=$(mktemp -d)
trap 'rm -rf "$TMP"' EXIT

python3 -m swiftortho_tpu_torch.tools.make_corpus "$TMP/ref.fsa" 5 80 42 \
    > /dev/null

# stage by stage (reference example/run.sh:14-20 config)
python3 -m swiftortho_tpu_torch.cli.find_hit -p blastp -i "$TMP/ref.fsa" \
    -d "$TMP/ref.fsa" -o "$TMP/ref.sc" -e 1e-5 -s 1111111 -r aa20 -M 4194304
python3 -m swiftortho_tpu_torch.cli.find_orth -i "$TMP/ref.sc" -c 0.5 -y 0 \
    > "$TMP/ref.orth"
python3 -m swiftortho_tpu_torch.cli.find_cluster -i "$TMP/ref.orth" -a apc \
    > "$TMP/ref.apc"
python3 -m swiftortho_tpu_torch.cli.find_cluster -i "$TMP/ref.orth" -a mcl \
    > "$TMP/ref.mcl"

for f in ref.sc ref.orth ref.apc ref.mcl; do
    test -s "$TMP/$f" || { echo "FAIL: $f empty"; exit 1; }
done
echo "ref.sc md5 $(md5sum < "$TMP/ref.sc" | cut -d' ' -f1)"
python3 -m swiftortho_tpu_torch.cli.scripts mcl_cmp "$TMP/ref.mcl" \
    "$TMP/ref.apc"

# full pipeline (reference example/run.sh:30)
python3 -m swiftortho_tpu_torch.cli.run_all -i "$TMP/ref.fsa" -s 1111111111 \
    -A mcl -M 4194304 -y 0 > /dev/null
test -s "$TMP/ref.fsa_results/ref.fsa.pan" || { echo "FAIL: pan empty"; exit 1; }
test -s "$TMP/ref.fsa_results/ref.fsa.nwk" || { echo "FAIL: nwk empty"; exit 1; }

echo "example_run: all stages OK"
