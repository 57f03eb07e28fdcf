"""Procedural scenes, the card-against-CPU gates and the chi-square test
(``chi2``) for tests and the chip smoke run."""
