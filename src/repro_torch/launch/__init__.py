"""Entry points of the port's LM substrate: serving (``serve``) and
training on one card (``train``), and their step factories (``steps``)."""
