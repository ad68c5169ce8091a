"""Host-native record transport of the port: the shared-memory feed ring
(``shm``, over ``native/shmqueue.cpp``) and the row <-> column marshal
(``marshal``, over ``native/marshal.c``), both built at first use by
``_build``."""
