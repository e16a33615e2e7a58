"""Offline suffix-array pipeline: FASTA -> .ref -> .sa (PyTorch port; the
twin of tools/ref_to_suffix_array.py, host only).

Equivalent of the reference's three-process shell pipeline
(reference: suffixarray/refToSuffixArray.sh:1-35 = trimRef | mksary
(libdivsufsort, int64-patched) | addlcp), collapsed into one command
around the native SA-IS builder:

    python -m sapling_tpu_torch.tools.ref_to_suffix_array <genome.fa>
        [out_prefix]

Writes:
  <prefix>.ref  — filtered raw bases (trimRef.cpp:14-38 semantics:
                  uppercased, non-ACGT dropped, no newlines)
  <prefix>.sa   — reference-format [n][inv][lcpSize][lcp]
                  (addlcp.cpp:52-77)
Existing outputs are skipped (refToSuffixArray.sh:32-35 pattern).
"""

from __future__ import annotations

import os
import sys
import time

from ..index.suffix_array import build_suffix_data
from ..io import artifacts
from ..io.fasta import read_fasta


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 1
    fa = argv[1]
    prefix = argv[2] if len(argv) > 2 else fa
    ref_out = prefix + ".ref"
    sa_out = prefix + ".sa"
    genome = read_fasta(fa)
    print(f"filtered genome: {genome.n} bases, "
          f"{len(genome.chr_ends)} sequences")
    if not os.path.exists(ref_out):
        with open(ref_out, "wb") as f:
            f.write(genome.seq.tobytes())
        print(f"wrote {ref_out}")
    else:
        print(f"skip {ref_out} (exists)")
    if not os.path.exists(sa_out):
        t0 = time.time()
        sd = build_suffix_data(genome.seq)
        artifacts.write_sa(sa_out, sd.inv, sd.lcp)
        print(f"wrote {sa_out} (SA-IS + Kasai in {time.time() - t0:.1f}s)")
    else:
        print(f"skip {sa_out} (exists)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
