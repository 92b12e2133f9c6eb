#!/usr/bin/env bash
# Incremental per-accession sketch -> merge workflow (mirrors the
# reference's pipeSketch.sh): sketches are the checkpoints; merge
# combines them (SURVEY §5 checkpoint/resume contract).
if [ $# -lt 1 ]; then
  echo "Usage: $0 SRA_accession.list"
  echo "One SRA accession id per line"
  exit 1
fi
accessionList=$1
mkdir -p tmpSketchDir
rm -f tmpSketchDir/*

while read -r line; do
  fastq-dump "$line"
  ls ${line}.fastq > ${line}.list
  rabbitkssd sketch -L shuf_file/L3K10.shuf -i ${line}.list -o tmpSketchDir/${line}.sketch -q
  rm ${line}.fastq ${line}.list
done < "$accessionList"

ls tmpSketchDir/*.sketch > tmpSketch.list
rabbitkssd merge -i tmpSketch.list -o ${accessionList}.sketch
rm tmpSketch.list
rm -rf tmpSketchDir
