"""``python -m dfac_tpu_torch.cli.generate_submission`` — the leaderboard file.

Counterpart of ``dfac-generate-submission``
(:mod:`dfac_tpu.cli.generate_submission`), parity target reference
``scripts/generate_submission.py``: the same positional arguments and the
same pickled artifact.
"""

from __future__ import annotations

import sys

from dfac_tpu_torch.io.submission import generate_submission


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 6:
        raise ValueError(
            "Usage: generate_submission <features.pkl> <prediction.pkl> "
            "<Student_ID> <FirstName> <LastName> <Nickname>"
        )
    out = generate_submission(*argv)
    print(f"Submission file saved to: {out}")


if __name__ == "__main__":
    main()
