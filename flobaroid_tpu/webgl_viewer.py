"""Self-contained interactive WebGL trajectory viewer.

Interactive counterpart of the reference's pyglet/OpenGL visualizer
(reference visualizer.py:910-2153: FPS camera, mesh render modes,
collision highlighting, torque arcs) re-designed for a headless
workflow: instead of a GL window on the host, the viewer exports ONE
self-contained HTML file (no external JS, works offline) with

  * raw-WebGL flat-shaded rendering of the link meshes / capsule
    geometry / world boxes,
  * an orbit camera (drag = rotate, wheel = zoom, shift-drag = pan),
  * trajectory playback (play/pause + scrubber) driven by per-frame
    link transforms PRECOMPUTED by the JAX FK — the browser only
    applies rigid transforms, no kinematics in JS,
  * per-frame collision-violation highlighting (violating links turn
    red) and per-joint torque-utilization bars.

Geometry and transforms are embedded as base64 Float32Arrays; a
13k-sample 30-DOF trajectory at step=10 is ~2 MB of HTML.
"""

from __future__ import annotations

import base64
import json

import numpy as np


def _capsule_mesh(p0, p1, r, n_seg=12, n_cap=4):
    """Solid capsule triangle soup (link frame)."""
    p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
    d = p1 - p0
    L = np.linalg.norm(d)
    d = d / L if L > 1e-9 else np.array([0.0, 0.0, 1.0])
    a = np.array([1.0, 0, 0]) if abs(d[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(d, a)
    u /= np.linalg.norm(u)
    v = np.cross(d, u)
    th = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = np.outer(np.cos(th), u) + np.outer(np.sin(th), v)  # (n_seg, 3)
    tris = []

    def quad(a0, a1, b0, b1):
        tris.append([a0, a1, b1])
        tris.append([a0, b1, b0])

    # cylinder side
    for i in range(n_seg):
        j = (i + 1) % n_seg
        quad(p0 + r * ring[i], p0 + r * ring[j], p1 + r * ring[i], p1 + r * ring[j])
    # spherical caps (latitude rings toward the poles)
    for sign, base in ((-1.0, p0), (1.0, p1)):
        prev = [base + r * ring[i] for i in range(n_seg)]
        for k in range(1, n_cap + 1):
            phi = k / n_cap * (np.pi / 2)
            rr = r * np.cos(phi)
            h = r * np.sin(phi) * sign
            cur = [base + rr * ring[i] + h * d for i in range(n_seg)]
            for i in range(n_seg):
                j = (i + 1) % n_seg
                quad(prev[i], prev[j], cur[i], cur[j])
            prev = cur
    return np.asarray(tris)


def _box_soup(center, half, R):
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    ) * np.asarray(half)
    vw = corners @ np.asarray(R).T + np.asarray(center)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, c, d in quads:
        tris += [[vw[a], vw[b], vw[c]], [vw[a], vw[c], vw[d]]]
    return np.asarray(tris)


def _flat_buffers(tris):
    """(positions, normals) flat f32 arrays from a (T, 3, 3) soup."""
    tris = np.asarray(tris, np.float32)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    normals = np.repeat(n[:, None, :], 3, axis=1)
    return tris.reshape(-1).astype(np.float32), normals.reshape(-1).astype(np.float32)


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a, np.float32).tobytes()).decode()


def export_webgl(viz, Q, filename="trajectory_3d.html", base_rpy=None,
                 base_pos=None, step=10, torques=None, fps=20):
    """Write the interactive viewer HTML for trajectory Q (N, n_dofs).

    `viz` is a flobaroid_tpu.visualizer.Visualizer (provides the tree,
    FK, link meshes, collision model and torque limits)."""
    import jax.numpy as jnp

    from .dynamics import spatial as sp

    tree = viz.tree
    idx = list(range(0, len(Q), max(1, int(step))))

    # ---------------- static geometry per link ----------------
    link_geoms = []  # (link_index, positions_b64, normals_b64, n_verts)
    for li in range(tree.num_links):
        soups = []
        for tris, Rv, tv in viz.link_meshes.get(li, []):
            soups.append(np.einsum("ij,ntj->nti", Rv, tris) + tv)
        if not soups and viz.cm is not None:
            name = tree.link_names[li]
            cap = viz.cm.capsules.get(name)
            if cap is not None:
                soups.append(_capsule_mesh(cap.p0, cap.p1, cap.radius))
        if not soups:
            continue
        pos, nrm = _flat_buffers(np.concatenate(soups))
        link_geoms.append((li, _b64(pos), _b64(nrm), len(pos) // 3))

    # world boxes: static geometry under identity transform
    world_geoms = []
    if viz.cm is not None:
        for name, (center, half, R) in getattr(viz.cm, "world_boxes", {}).items():
            pos, nrm = _flat_buffers(_box_soup(center, half, R))
            world_geoms.append((name, _b64(pos), _b64(nrm), len(pos) // 3))

    # ---------------- per-frame transforms + annotations ----------------
    F = len(idx)
    L = tree.num_links
    xf = np.zeros((F, L, 12), np.float32)  # row-major [R | p]
    viol = []
    utils = None
    if torques is not None and viz.tau_limits is not None:
        utils = np.zeros((F, len(viz.tau_limits)), np.float32)
    for f, k in enumerate(idx):
        br = None
        if base_rpy is not None:
            br = np.asarray(sp.rpy_to_rot(jnp.asarray(base_rpy[k]))).T
        bp = None if base_pos is None else np.asarray(base_pos[k])
        R, p = viz._link_world(Q[k], br, bp)
        xf[f, :, :9] = R.reshape(L, 9)
        xf[f, :, 9:] = p
        links = []
        if viz.cm is not None:
            ok, viols = viz.cm.check(np.asarray(Q[k]), br, bp,
                                     margin=viz.collision_margin)
            bad = set()
            for (a, b), _d in viols:
                bad.add(a)
                bad.add(b)
            links = sorted(tree.link_index[n] for n in bad if n in tree.link_index)
        viol.append(links)
        if utils is not None:
            tau_k = np.asarray(torques[k], float)[-len(viz.tau_limits):]
            utils[f] = np.abs(tau_k) / np.maximum(viz.tau_limits, 1e-9)

    meta = dict(
        links=[dict(li=li, n=n) for li, _, _, n in link_geoms],
        world=[dict(name=nm, n=n) for nm, _, _, n in world_geoms],
        frames=F,
        num_links=L,
        viol=viol,
        joints=list(tree.dof_names),
        fps=int(fps),
        samples=idx,
    )
    html = _HTML_TEMPLATE
    html = html.replace("__META__", json.dumps(meta))
    html = html.replace("__XF__", _b64(xf.reshape(-1)))
    html = html.replace("__UTILS__", _b64(utils.reshape(-1)) if utils is not None else "")
    html = html.replace(
        "__LINKBUF__",
        json.dumps([[g[1], g[2]] for g in link_geoms]),
    )
    html = html.replace(
        "__WORLDBUF__",
        json.dumps([[g[1], g[2]] for g in world_geoms]),
    )
    with open(filename, "w") as fh:
        fh.write(html)
    return filename


_HTML_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>flobaroid_tpu trajectory</title>
<style>
 body{margin:0;background:#14161a;color:#dfe3ea;font:13px sans-serif;overflow:hidden}
 #hud{position:absolute;left:10px;top:8px}
 #bars{position:absolute;right:10px;top:8px;background:#1c2026cc;padding:6px;border-radius:6px}
 #bars div.row{display:flex;align-items:center;height:11px}
 #bars span{width:70px;text-align:right;margin-right:4px;font-size:9px;color:#9aa3b2}
 #bars i{display:block;height:7px;background:#4c8dff;border-radius:2px}
 #bars i.over{background:#ff5050}
 #ctl{position:absolute;left:0;right:0;bottom:0;background:#1c2026;padding:8px 12px;display:flex;gap:10px;align-items:center}
 #sl{flex:1}
 button{background:#2a2f37;color:#dfe3ea;border:1px solid #3a414c;border-radius:4px;padding:3px 14px;cursor:pointer}
</style></head><body>
<canvas id="gl"></canvas>
<div id="hud">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan</div>
<div id="bars"></div>
<div id="ctl"><button id="play">play</button><input id="sl" type="range" min="0" value="0"><span id="lbl"></span></div>
<script>
const META=__META__;
function f32(b){const s=atob(b);const a=new Uint8Array(s.length);for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new Float32Array(a.buffer);}
const XF=f32("__XF__");
const UTILS_B="__UTILS__";const UTILS=UTILS_B?f32(UTILS_B):null;
const LINKBUF=__LINKBUF__, WORLDBUF=__WORLDBUF__;
const cv=document.getElementById('gl');const gl=cv.getContext('webgl');
const VS=`attribute vec3 pos;attribute vec3 nrm;uniform mat4 mvp;uniform mat3 mrot;varying vec3 vn;varying vec3 vp;
void main(){gl_Position=mvp*vec4(pos,1.0);vn=mrot*nrm;vp=pos;}`;
const FS=`precision mediump float;uniform vec3 color;uniform vec3 lightDir;varying vec3 vn;
void main(){float d=abs(dot(normalize(vn),lightDir));gl_FragColor=vec4(color*(0.35+0.65*d),1.0);}`;
function shader(t,s){const h=gl.createShader(t);gl.shaderSource(h,s);gl.compileShader(h);return h;}
const prog=gl.createProgram();gl.attachShader(prog,shader(gl.VERTEX_SHADER,VS));gl.attachShader(prog,shader(gl.FRAGMENT_SHADER,FS));gl.linkProgram(prog);gl.useProgram(prog);
const aPos=gl.getAttribLocation(prog,'pos'),aNrm=gl.getAttribLocation(prog,'nrm');
const uMvp=gl.getUniformLocation(prog,'mvp'),uRot=gl.getUniformLocation(prog,'mrot'),uCol=gl.getUniformLocation(prog,'color'),uLight=gl.getUniformLocation(prog,'lightDir');
gl.enable(gl.DEPTH_TEST);
function mkbuf(arr){const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);gl.bufferData(gl.ARRAY_BUFFER,arr,gl.STATIC_DRAW);return b;}
const links=META.links.map((m,i)=>({li:m.li,n:m.n,pb:mkbuf(f32(LINKBUF[i][0])),nb:mkbuf(f32(LINKBUF[i][1]))}));
const world=META.world.map((m,i)=>({n:m.n,pb:mkbuf(f32(WORLDBUF[i][0])),nb:mkbuf(f32(WORLDBUF[i][1]))}));
// ---- camera (orbit) ----
let yaw=0.8,pitch=0.45,dist=3.0,target=[0,0,0.5];
cv.addEventListener('mousedown',e=>{
 const move=ev=>{const dx=ev.movementX,dy=ev.movementY;
  if(ev.shiftKey||e.button===2){const s=0.002*dist;
   target[0]-=s*(Math.cos(yaw)*dx - 0);target[1]-=s*(Math.sin(yaw)*dx);target[2]+=s*dy;}
  else{yaw-=dx*0.008;pitch=Math.min(1.5,Math.max(-1.5,pitch+dy*0.008));}draw();};
 const up=()=>{window.removeEventListener('mousemove',move);window.removeEventListener('mouseup',up);};
 window.addEventListener('mousemove',move);window.addEventListener('mouseup',up);});
cv.addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);dist=Math.min(30,Math.max(0.3,dist));draw();e.preventDefault();});
cv.addEventListener('contextmenu',e=>e.preventDefault());
// ---- matrices ----
function persp(fov,asp,near,far){const f=1/Math.tan(fov/2);return [f/asp,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1, 0,0,2*far*near/(near-far),0];}
function mul(a,b){const o=new Array(16).fill(0);for(let r=0;r<4;r++)for(let c=0;c<4;c++)for(let k=0;k<4;k++)o[c*4+r]+=a[k*4+r]*b[c*4+k];return o;}
function lookAt(eye,ct,up){
 let z=[eye[0]-ct[0],eye[1]-ct[1],eye[2]-ct[2]];let zl=Math.hypot(...z);z=z.map(v=>v/zl);
 let x=[up[1]*z[2]-up[2]*z[1],up[2]*z[0]-up[0]*z[2],up[0]*z[1]-up[1]*z[0]];let xl=Math.hypot(...x);x=x.map(v=>v/xl);
 const y=[z[1]*x[2]-z[2]*x[1],z[2]*x[0]-z[0]*x[2],z[0]*x[1]-z[1]*x[0]];
 return [x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
  -(x[0]*eye[0]+x[1]*eye[1]+x[2]*eye[2]),-(y[0]*eye[0]+y[1]*eye[1]+y[2]*eye[2]),-(z[0]*eye[0]+z[1]*eye[1]+z[2]*eye[2]),1];}
let frame=0;
const sl=document.getElementById('sl');sl.max=META.frames-1;
const lbl=document.getElementById('lbl');
function linkMat(f,li){const o=XF.subarray((f*META.num_links+li)*12,(f*META.num_links+li)*12+12);
 // row-major R|p -> column-major 4x4
 return [o[0],o[3],o[6],0, o[1],o[4],o[7],0, o[2],o[5],o[8],0, o[9],o[10],o[11],1];}
function draw(){
 const w=window.innerWidth,h=window.innerHeight;
 if(cv.width!==w||cv.height!==h){cv.width=w;cv.height=h;gl.viewport(0,0,w,h);}
 gl.clearColor(0.078,0.086,0.102,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const eye=[target[0]+dist*Math.cos(pitch)*Math.cos(yaw),target[1]+dist*Math.cos(pitch)*Math.sin(yaw),target[2]+dist*Math.sin(pitch)];
 const view=lookAt(eye,target,[0,0,1]);
 const proj=persp(0.9,w/h,0.05,100);
 const vp=mul(proj,view);
 gl.uniform3fv(uLight,[0.4,0.25,0.88]);
 const bad=new Set(META.viol[frame]||[]);
 for(const L of links){
  const m=linkMat(frame,L.li);
  gl.uniformMatrix4fv(uMvp,false,new Float32Array(mul(vp,m)));
  gl.uniformMatrix3fv(uRot,false,new Float32Array([m[0],m[1],m[2],m[4],m[5],m[6],m[8],m[9],m[10]]));
  gl.uniform3fv(uCol,bad.has(L.li)?[1.0,0.30,0.30]:[0.45,0.62,0.95]);
  gl.bindBuffer(gl.ARRAY_BUFFER,L.pb);gl.enableVertexAttribArray(aPos);gl.vertexAttribPointer(aPos,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,L.nb);gl.enableVertexAttribArray(aNrm);gl.vertexAttribPointer(aNrm,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.TRIANGLES,0,L.n);}
 const ident=[1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,0,1];
 for(const W of world){
  gl.uniformMatrix4fv(uMvp,false,new Float32Array(vp));
  gl.uniformMatrix3fv(uRot,false,new Float32Array([1,0,0,0,1,0,0,0,1]));
  gl.uniform3fv(uCol,[0.55,0.55,0.5]);
  gl.bindBuffer(gl.ARRAY_BUFFER,W.pb);gl.enableVertexAttribArray(aPos);gl.vertexAttribPointer(aPos,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,W.nb);gl.enableVertexAttribArray(aNrm);gl.vertexAttribPointer(aNrm,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.TRIANGLES,0,W.n);}
 lbl.textContent='sample '+META.samples[frame];
 bars();
}
function bars(){
 if(!UTILS)return;const el=document.getElementById('bars');const n=META.joints.length;
 let html='';
 for(let j=0;j<n;j++){const u=UTILS[frame*n+j];
  html+='<div class="row"><span>'+META.joints[j]+'</span><i class="'+(u>1?'over':'')+'" style="width:'+Math.min(120,u*100)+'px"></i></div>';}
 el.innerHTML=html;}
sl.oninput=()=>{frame=+sl.value;draw();};
let timer=null;
document.getElementById('play').onclick=function(){
 if(timer){clearInterval(timer);timer=null;this.textContent='play';return;}
 this.textContent='pause';
 timer=setInterval(()=>{frame=(frame+1)%META.frames;sl.value=frame;draw();},1000/META.fps);};
window.addEventListener('resize',draw);
draw();
</script></body></html>
"""
