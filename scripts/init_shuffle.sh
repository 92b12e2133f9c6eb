#!/usr/bin/env bash
# Pre-generate the 12 standard shuffle files (mirrors the reference's
# init_shuffle.sh, /root/reference/init_shuffle.sh) — byte-identical
# .shuf artifacts via the bit-exact glibc-rand emulation.
set -e
mkdir -p shuf_file

rabbitkssd shuffle -k 11 -s 6 -l 4 -o shuf_file/L4K11.shuf
rabbitkssd shuffle -k 10 -s 6 -l 4 -o shuf_file/L4K10.shuf
rabbitkssd shuffle -k 9  -s 6 -l 4 -o shuf_file/L4K9.shuf
rabbitkssd shuffle -k 8  -s 6 -l 4 -o shuf_file/L4K8.shuf

rabbitkssd shuffle -k 11 -s 6 -l 3 -o shuf_file/L3K11.shuf
rabbitkssd shuffle -k 10 -s 6 -l 3 -o shuf_file/L3K10.shuf
rabbitkssd shuffle -k 9  -s 6 -l 3 -o shuf_file/L3K9.shuf
rabbitkssd shuffle -k 8  -s 6 -l 3 -o shuf_file/L3K8.shuf

rabbitkssd shuffle -k 10 -s 6 -l 2 -o shuf_file/L2K10.shuf
rabbitkssd shuffle -k 9  -s 6 -l 2 -o shuf_file/L2K9.shuf
rabbitkssd shuffle -k 8  -s 6 -l 2 -o shuf_file/L2K8.shuf
rabbitkssd shuffle -k 7  -s 6 -l 2 -o shuf_file/L2K7.shuf
