#!/usr/bin/env bash
# The port's lint gate: the check plane's lint over ompi_tpu_torch, as
# scripts/lint_gate.sh runs it over the JAX package.
#   1. a cold run with the incremental cache and a SARIF export: the
#      tree must lint clean (exit 0) within LINT_BUDGET_SECONDS (30 by
#      default);
#   2. a warm run against the same cache: every file must come from it;
#   3. the SARIF document is 2.1.0, carries the rule catalog and holds no
#      unsuppressed result.
# Usage: bash scripts/torch_lint_gate.sh [OUT_DIR]  (build/torch_lint_gate)
set -euo pipefail
cd "$(dirname "$0")/.."

out="${1:-build/torch_lint_gate}"
budget="${LINT_BUDGET_SECONDS:-30}"
rm -rf "$out"
mkdir -p "$out"

echo "== torch lint gate: cold run (cache + SARIF) =="
start=$(date +%s)
python -m ompi_tpu_torch.check lint ompi_tpu_torch \
  --cache "$out/lint_cache.json" \
  --sarif "$out/lint.sarif" 2> "$out/cold.log"
cat "$out/cold.log" >&2
elapsed=$(( $(date +%s) - start ))
echo "cold run: ${elapsed}s (budget ${budget}s)"
if [ "$elapsed" -gt "$budget" ]; then
  echo "torch lint gate: cold lint took ${elapsed}s > ${budget}s budget" >&2
  exit 1
fi

echo "== torch lint gate: warm run (cache effectiveness) =="
python -m ompi_tpu_torch.check lint ompi_tpu_torch \
  --cache "$out/lint_cache.json" 2> "$out/warm.log"
cat "$out/warm.log" >&2

python - "$out" <<'PY'
import json
import re
import sys

out = sys.argv[1]
warm = open(out + "/warm.log").read()
m = re.search(r"(\d+)/(\d+) file\(s\) from cache", warm)
assert m, f"no cache counters in the warm run's summary:\n{warm}"
cached, total = int(m.group(1)), int(m.group(2))
assert total > 0 and cached == total, (
    f"the warm run reused {cached}/{total} files: the cache is not "
    "effective")
doc = json.load(open(out + "/lint.sarif"))
assert doc["version"] == "2.1.0", doc["version"]
run = doc["runs"][0]
assert run["tool"]["driver"]["rules"], "empty SARIF rule catalog"
bad = [r for r in run["results"] if not r.get("suppressions")]
assert not bad, f"unsuppressed findings in the SARIF document: {bad}"
print(f"torch lint gate OK: clean tree, {cached}/{total} files from the "
      f"cache on the warm run, SARIF 2.1.0 with "
      f"{len(run['tool']['driver']['rules'])} rules and "
      f"{len(run['results'])} suppressed results")
PY
