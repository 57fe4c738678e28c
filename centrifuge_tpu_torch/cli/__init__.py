"""Command-line tools of the port, the reference CLI surface:

  classify   centrifuge           classification driver, on the card
  build      centrifuge-build     index builder
  inspect    centrifuge-inspect   index inspection
  kreport    centrifuge-kreport   Kraken-style report
  download   centrifuge-download  DB/taxonomy fetcher
  promote    centrifuge-promote   taxID rank promotion
  simulate   read simulator with a truth table (evaluation/simulate.py)
  evaluate   accuracy against a truth table (evaluation/evaluate.py)

Invoke as `python -m centrifuge_tpu_torch <tool> ...`. Every tool but
classify is host code, copied from the JAX package's cli/.
"""
