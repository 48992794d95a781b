"""Seeded corpus generators, one file each; a traffic file names one."""
