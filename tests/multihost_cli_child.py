"""Child for the 2-process CLI end-to-end test (CPU backend).

Runs the REAL CLI surface (`rabbitkssd.cli.main`) under
jax.distributed: ``sketch``, ``alldist``, ``dist`` (incl. the top-N
heap path), and a ``union``/``sub``/``merge``/``info`` chain on the
corpus the parent prepared (argv[1] = genome list, argv[2] = .shuf
file, argv[3] = output directory private to this process).  Every
process computes replicated results (read_array gathers across hosts)
and writes its own artifact copies; the parent asserts all copies are
byte-identical to a single-process run — the pod-scale execution
contract of BASELINE config 5 proven through the user-facing entry
point, not per-function.  The dist leg exercises the ring-rotated
ref-vs-query path + StdPriorityQueue replay (reference
dist.cpp:429-776) under jax.distributed; the setops leg the streaming
bitmap set algebra (subCommand.cpp:307-892).
"""

import os
import sys

from rabbitkssd.cli import main

list_path, shuf_path, outdir = sys.argv[1:4]
list_path, shuf_path = os.path.abspath(list_path), os.path.abspath(shuf_path)
os.makedirs(outdir, exist_ok=True)
# run from the private outdir with RELATIVE artifact names: sketch
# names embedded in set-op outputs (union's "<input> merged sketches",
# subCommand.cpp:360) must match across processes for byte equality
os.chdir(outdir)
sketch_out = "corpus.sketch"
dist_out = "corpus.alldist"

rc = main(["sketch", "-L", shuf_path, "-i", list_path, "-o", sketch_out])
assert rc == 0, f"sketch failed with {rc}"
rc = main(["alldist", "-i", sketch_out, "-L", shuf_path,
           "-o", dist_out, "-D", "1.0"])
assert rc == 0, f"alldist failed with {rc}"

# ref-vs-query split of the same corpus: first 4 genomes reference,
# last 2 query; -N 2 takes the bounded-heap top-N emission path
with open(list_path) as f:
    files = [ln for ln in f.read().splitlines() if ln]
with open("ref.list", "w") as f:
    f.write("\n".join(files[:4]) + "\n")
with open("qry.list", "w") as f:
    f.write("\n".join(files[4:]) + "\n")
rc = main(["dist", "-r", "ref.list", "-q", "qry.list", "-L", shuf_path,
           "-o", "rq.dist", "-D", "1.0"])
assert rc == 0, f"dist failed with {rc}"
rc = main(["dist", "-r", "ref.list", "-q", "qry.list", "-L", shuf_path,
           "-o", "rq_top2.dist", "-D", "1.0", "-N", "2"])
assert rc == 0, f"dist -N failed with {rc}"

# set-algebra chain over the sketch artifact
rc = main(["union", "-i", sketch_out, "-o", "u.sketch"])
assert rc == 0, f"union failed with {rc}"
rc = main(["sub", "--rs", "u.sketch", "--qs", sketch_out,
           "-o", "s.sketch"])
assert rc == 0, f"sub failed with {rc}"
with open("merge.list", "w") as f:
    f.write(sketch_out + "\n" + "u.sketch\n")
rc = main(["merge", "-i", "merge.list", "-o", "m.sketch"])
assert rc == 0, f"merge failed with {rc}"
rc = main(["info", "-i", "m.sketch", "-o", "m.info", "-F"])
assert rc == 0, f"info failed with {rc}"
print("CLI-OK", flush=True)
sys.exit(0)
