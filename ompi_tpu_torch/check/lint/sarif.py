"""SARIF 2.1.0 export for the lint gate — the GitHub code-scanning
interchange format, so CI findings land as PR annotations instead of
log lines.

Shape per the OASIS sarif-2.1.0 schema: one ``run`` with the full
rule catalog on ``tool.driver`` (stable ``ruleIndex`` references)
and one ``result`` per finding. Suppressed findings are carried with
``suppressions: [{kind: "inSource"}]`` and baselined ones with
``kind: "external"`` — code scanning hides them but the audit trail
stays in the artifact.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List

from ompi_tpu_torch.check.lint.model import Finding

SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
          "master/Schemata/sarif-schema-2.1.0.json")
TOOL_NAME = "ompi_tpu_torch-check-lint"
TOOL_URI = "https://github.com/jtronge/ompi"


def to_sarif(findings: Iterable[Finding],
             tool_version: str = "2.0") -> Dict:
    from ompi_tpu_torch.check.lint.rules import CATALOG

    rule_ids: List[str] = sorted(CATALOG)
    index = {r: i for i, r in enumerate(rule_ids)}
    results = []
    for f in findings:
        res = {
            "ruleId": f.rule,
            "ruleIndex": index.get(f.rule, -1),
            "level": "warning" if (f.suppressed or f.baselined)
                     else "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path.replace("\\", "/"),
                    },
                    "region": {"startLine": max(1, f.line)},
                },
            }],
        }
        if f.suppressed:
            res["suppressions"] = [{"kind": "inSource"}]
        elif f.baselined:
            res["suppressions"] = [{
                "kind": "external",
                "justification": "accepted in the findings baseline",
            }]
        results.append(res)
    return {
        "$schema": SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": TOOL_NAME,
                    "informationUri": TOOL_URI,
                    "version": tool_version,
                    "rules": [
                        {"id": r,
                         "shortDescription": {"text": CATALOG[r]}}
                        for r in rule_ids
                    ],
                },
            },
            "columnKind": "utf16CodeUnits",
            "results": results,
        }],
    }


def write_sarif(findings: Iterable[Finding], path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(to_sarif(findings), fh, indent=1)
