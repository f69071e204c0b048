"""Command-line tools of the port (the JAX package's tools/, adapted):
gen, rungen, traceviz, tilesearch, fitcost and abtest; `timer` is their
frame timer."""
