"""The plain reference of the configuration ``softimax_chain``: the one of
``softimax`` (``references/softimax.py``), which the frozen check of
``configs/softimax.py`` reads for both configurations.  Not a second copy:
its ``compare`` is that module's."""
import harness

compare = harness.load_module('references', 'softimax').compare
